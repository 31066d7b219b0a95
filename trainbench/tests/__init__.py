"""CPU tests of the benchmark: the plain reference against the program at
small sizes, the control and the planted faults, the yardstick and the
data files. Tests that need a card are marked ``cuda``."""
