"""Host-side gradient-coding machinery (Glasgow & Wootters 2020).

NumPy copies of the ``repro.core`` modules that serving reaches:

- graphs:       expander constructions (incl. the exact LPS X^{5,13})
- assignment:   graph / FRC / uncoded schemes
- stragglers:   Bernoulli / fixed-count / Markov / adversarial masks
- decoding:     O(m) optimal graph decoder, pseudoinverse, FRC, fixed
- batched_decoding: the (trials, m)-at-once alpha* engine (NumPy)
- step_weights: straggler model factory, w*/alpha, served blocks
"""

from .graphs import (Graph, circulant_graph, complete_graph, cycle_graph,
                     hypercube_graph, lps_graph, make_expander,
                     random_regular_graph)
from .assignment import (Assignment, expander_assignment, frc_assignment,
                         graph_assignment, uncoded_assignment)
from .decoding import (DecodeResult, decode, fixed_decode,
                       normalized_error, optimal_alpha_graph,
                       optimal_decode_frc, optimal_decode_graph,
                       optimal_decode_pinv)
from .batched_decoding import (batched_alpha, batched_fixed_alpha,
                               batched_frc_alpha,
                               batched_optimal_alpha_graph,
                               counts_are_exact)
from .stragglers import (AdversarialStragglers, BernoulliStragglers,
                         FixedCountStragglers, MarkovStragglers,
                         StragglerModel, adversarial_mask,
                         adversarial_mask_frc, adversarial_mask_graph)
from . import step_weights
