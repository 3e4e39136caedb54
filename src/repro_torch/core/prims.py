"""Single source of truth for primitive classification tables.

The jaxpr extractor (``core.jaxpr_graph``) and the measured cost model
(``core.cost_model``) both need to answer "what kind of work is this node?"
— heavy vs light for the paper's 10/1 cost model, compute- vs memory-bound
for calibration, call-like vs leaf for recursion.  These tables used to be
duplicated across the two modules; they live here once, and both import
them (the old module attributes remain as aliases for compatibility).
"""

from __future__ import annotations

#: Primitives whose cost dominates a graph under the paper's 10/1 model:
#: the dot/conv family plus the call-like wrappers that may contain them.
HEAVY_PRIMS = frozenset({
    "dot_general",
    "conv_general_dilated",
    "ragged_dot",
    "scan",
    "while",
    "pjit",
    "closed_call",
    "custom_vjp_call",
    "custom_jvp_call",
    "remat",
    "checkpoint",
})

#: The dot/conv leaf primitives themselves (heavy without looking inside).
MATMUL_PRIMS = frozenset({"dot_general", "conv_general_dilated", "ragged_dot"})

#: Layout/view primitives that move no FLOPs worth modelling.
ELEMENTWISE_FREE = frozenset({
    "broadcast_in_dim",
    "reshape",
    "squeeze",
    "transpose",
    "convert_element_type",
    "slice",
    "dynamic_slice",
    "concatenate",
})

#: Call-like primitives whose cost lives in an inner jaxpr; FLOP/byte
#: accounting recurses into these (scan multiplies by trip count).
HIGHER_ORDER_PRIMS = frozenset({
    "pjit",
    "closed_call",
    "custom_vjp_call",
    "custom_jvp_call",
    "remat",
    "remat2",
    "checkpoint",
    "scan",
    "while",
    "cond",
})

#: ``eqn.params`` keys under which an inner (closed) jaxpr may hide.
INNER_JAXPR_KEYS = (
    "jaxpr",
    "call_jaxpr",
    "cond_jaxpr",
    "body_jaxpr",
    "branches",
)

#: PRNG-consuming primitives.  JAX's functional PRNG makes them
#: deterministic given the same key operand, but a plan that *recomputes*
#: one re-derives random bits during the backward pass — a silent numerics
#: hazard the effect analysis (``repro_torch.analysis``) pins out of plans.
PRNG_PRIMS = frozenset({
    "threefry2x32",
    "random_seed",
    "random_wrap",
    "random_unwrap",
    "random_bits",
    "random_fold_in",
    "random_split",
    "random_gamma",
    "random_clone",
    "rng_bit_generator",
    "rng_uniform",
})

#: Primitives whose backward rule is user-defined: the remat twin replays
#: their forward, but nothing structural proves the replay agrees with the
#: residuals the custom VJP expects — effect analysis treats them as opaque
#: and pins their (storable) outputs.  ``pallas_call`` belongs here too:
#: a hand-written kernel (e.g. ``kernels/flash_attention.py``) is a black
#: box to the taint walker — it may carry scratch semantics, input aliasing
#: or nondeterministic reductions the jaxpr does not expose, so its outputs
#: must be pinned rather than silently treated as pure.
OPAQUE_PRIMS = frozenset({
    "custom_vjp_call",
    "custom_vjp_call_jaxpr",
    "custom_lin",
    "pallas_call",
})

#: ``eqn.params`` keys the *effect walker* recurses into — the FLOP
#: accounting's keys plus ``fun_jaxpr`` (where ``custom_vjp_call_jaxpr``
#: hides its primal body).
EFFECT_INNER_JAXPR_KEYS = INNER_JAXPR_KEYS + ("fun_jaxpr",)

#: Node kinds priced as compute-bound matmul-class work by the measured
#: cost model (``time`` field = FLOPs).
MATMUL_KINDS = frozenset({
    "dot_general",
    "conv_general_dilated",
    "ragged_dot",
    "unit",  # launch.plan.chain_graph interior nodes (FLOPs in `time`)
    "matmul",
    "conv",
})

#: Node kinds priced at the attention kernel's achieved rate.
ATTENTION_KINDS = frozenset({"attention", "flash_attention", "custom_vjp_call"})
