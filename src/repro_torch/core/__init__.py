"""Gradient coding with optimal decoding (Glasgow & Wootters 2020).

The port's counterpart of ``repro.core``, with the same public surface
(NumPy host code, bit-identical to the reference on the CPU):

- graphs:      expander constructions (incl. the exact LPS X^{5,13})
- assignment:  graph / FRC / adjacency / Bernoulli / uncoded schemes and
               the scheme zoo (cyclic-MDS, BIBD, random matchings)
- decoding:    O(m) optimal graph decoder, pseudoinverse, fixed, and the
               Monte-Carlo harness (``monte_carlo_error``)
- batched_decoding: the (trials, m)-at-once alpha* engine (pointer
               jumping on the double cover; NumPy, and torch on the card)
- sweep:       the (p_grid x trials) grid engine and campaigns
- spectral:    matrix-free spectra (Lanczos covariance norm over the
               Gram-matvec kernels, FFT circulant eigenvalues, sparse
               graph lambda_2)
- stragglers:  Bernoulli / fixed-count / Markov / adversarial attacks
- adaptive:    online p-hat estimation and per-step decoding policies
- step_weights: straggler model factory, mask sources, w*/alpha, served
               blocks, the Monte-Carlo debias scale
- compress:    none / int8 / sign / sign_packed gradient codecs
- theory:      the paper's closed-form bounds
- debias:      Prop B.1 black-box debiasing
- coded_gd:    Algorithms 2 & 3 (single-host logical view)

The harness entry points (``sweep_error``, ``sweep_campaign``,
``monte_carlo_error``, ``decode_grid``, the ``covariance_*`` functions)
take ``device=None``, which means the card; ``device="cpu"`` is the
reference's float64 path.
"""

from .graphs import (Graph, cycle_graph, complete_graph, hypercube_graph,
                     paley_graph, circulant_graph, random_regular_graph,
                     random_matching_regular_graph, lps_graph,
                     make_expander)
from .assignment import (Assignment, graph_assignment, expander_assignment,
                         frc_assignment, adjacency_assignment,
                         bernoulli_assignment, uncoded_assignment,
                         cyclic_mds_assignment, bibd_assignment,
                         random_matching_assignment)
from .decoding import (DecodeResult, decode, optimal_alpha_graph,
                       optimal_decode_graph, optimal_decode_pinv,
                       optimal_decode_frc, fixed_decode, normalized_error,
                       monte_carlo_error, debias_alpha)
from .batched_decoding import (batched_alpha, batched_fixed_alpha,
                               batched_frc_alpha,
                               batched_optimal_alpha_graph,
                               counts_are_exact, fixed_alpha_grid,
                               frc_alpha_grid)
from .sweep import (CampaignEntry, bernoulli_uniforms, decode_grid,
                    scheme_zoo_entries, sweep_campaign, sweep_error)
from . import spectral
from .spectral import (circulant_spectrum, covariance_spectral_norm,
                       covariance_spectral_norm_batch, covariance_topk,
                       graph_lambda2, lanczos_lambda_max,
                       lanczos_lambda_max_batch)
from .stragglers import (StragglerModel, BernoulliStragglers,
                         FixedCountStragglers, MarkovStragglers,
                         AdversarialStragglers,
                         adversarial_mask, adversarial_mask_graph,
                         adversarial_mask_frc, adversarial_mask_cyclic,
                         adversarial_mask_bibd)
from . import adaptive
from .adaptive import (OnlineStragglerEstimator, StragglerEstimate,
                       PolicyDecision, DecodingPolicy, StaticPolicy,
                       AdaptivePolicy, make_policy, replay_policy,
                       policy_regret_report)
from .step_weights import (make_straggler_model, sample_mask_stream,
                           batched_step_weights, debias_scale_mc)
from . import step_weights  # the module: step_weights.step_weights etc.
from . import compress
from .compress import Codec, get_codec
from . import theory
from .debias import debias_assignment, estimate_mean_alpha
from .coded_gd import (LeastSquares, GDTrace, gcod, precompute_alphas,
                       sgd_alg, uncoded_gd)

__all__ = [
    "Graph", "cycle_graph", "complete_graph", "hypercube_graph",
    "paley_graph", "circulant_graph", "random_regular_graph",
    "random_matching_regular_graph", "lps_graph", "make_expander",
    "Assignment", "graph_assignment", "expander_assignment",
    "frc_assignment", "adjacency_assignment", "bernoulli_assignment",
    "uncoded_assignment", "cyclic_mds_assignment", "bibd_assignment",
    "random_matching_assignment",
    "DecodeResult", "decode", "optimal_alpha_graph", "optimal_decode_graph",
    "optimal_decode_pinv", "optimal_decode_frc", "fixed_decode",
    "normalized_error", "monte_carlo_error", "debias_alpha",
    "batched_alpha", "batched_fixed_alpha", "batched_frc_alpha",
    "batched_optimal_alpha_graph", "counts_are_exact",
    "fixed_alpha_grid", "frc_alpha_grid",
    "CampaignEntry", "bernoulli_uniforms", "decode_grid",
    "scheme_zoo_entries", "sweep_campaign", "sweep_error",
    "spectral", "circulant_spectrum", "covariance_spectral_norm",
    "covariance_spectral_norm_batch", "covariance_topk",
    "graph_lambda2", "lanczos_lambda_max", "lanczos_lambda_max_batch",
    "StragglerModel", "BernoulliStragglers", "FixedCountStragglers",
    "MarkovStragglers", "AdversarialStragglers", "adversarial_mask",
    "adversarial_mask_graph", "adversarial_mask_frc",
    "adversarial_mask_cyclic", "adversarial_mask_bibd",
    "adaptive", "OnlineStragglerEstimator", "StragglerEstimate",
    "PolicyDecision", "DecodingPolicy", "StaticPolicy", "AdaptivePolicy",
    "make_policy", "replay_policy", "policy_regret_report",
    "step_weights", "make_straggler_model", "sample_mask_stream",
    "batched_step_weights", "debias_scale_mc",
    "compress", "Codec", "get_codec",
    "theory", "debias_assignment", "estimate_mean_alpha",
    "LeastSquares", "GDTrace", "gcod", "precompute_alphas", "sgd_alg",
    "uncoded_gd",
]
