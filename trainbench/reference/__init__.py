"""The plain float32 reference that decides a run's ``correct``: NumPy
coding (``coding``), PyTorch model families (``model``) and the checked
training steps (``train``). It imports nothing of the program."""
