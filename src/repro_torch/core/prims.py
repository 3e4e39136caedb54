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

# ---------------------------------------------------------------------------
# aten tables (``core.fx_graph``: one graph node per aten op of a make_fx
# trace).  Ops are named by their schema name without the ``aten::``
# namespace; ops of other namespaces keep theirs.
# ---------------------------------------------------------------------------

#: The flash-attention custom op (``kernels.ops``).
FLASH_OP = "repro_torch::flash_attention"
#: its backward operator (in a trace of a whole step)
FLASH_BWD_OP = "repro_torch::flash_attention_bwd"

#: The MoE dispatch's custom ops (``kernels.moe_dispatch``), traced on the
#: card: the slot map, the pack, the combine and their backwards.
MOE_OPS = frozenset(f"repro_torch::moe_{name}" for name in
                    ("slots", "pack", "pack_bwd", "combine", "combine_bwd"))

#: The sharding constraint (``parallel.constraint``), traced on a mesh that
#: splits more than the batch.
SHARD_OP = "repro_torch::shard"

#: Lookups along a vocab-sharded dim (``parallel.vocab``), traced on such a
#: mesh: the embedding's rows and the loss's gold logit.
VOCAB_EMBED_OP = "repro_torch::vocab_embed"
VOCAB_PICK_OP = "repro_torch::vocab_pick"

#: aten ops heavy under the paper's 10/1 model: the matmul/conv family and
#: the flash-attention op.
ATEN_HEAVY = frozenset({"mm", "bmm", "addmm", "convolution", FLASH_OP})

#: aten ops that draw from a random generator (the twin of ``PRNG_PRIMS``).
#: Torch's generators are stateful: a plan that recomputes one of these in
#: the backward draws fresh numbers unless the lowering restores the state,
#: so the effect analysis (``repro_torch.analysis.effects``) pins their
#: storable frontier.  In-place variants are listed too, though a
#: functionalized trace (``core.fx_graph``) holds only the out-of-place ones.
ATEN_PRNG = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "bernoulli", "bernoulli_", "native_dropout", "_fused_dropout",
    "normal", "normal_", "normal_functional", "uniform", "uniform_",
    "multinomial", "exponential", "exponential_", "geometric", "geometric_",
    "log_normal", "log_normal_", "cauchy", "cauchy_", "random", "random_",
    "poisson", "binomial", "_standard_gamma", "_sample_dirichlet",
    "rrelu_with_noise", "rrelu_with_noise_functional",
})

#: aten ops whose outputs alias their first input's storage: they fold into
#: the node of their base (no bytes to store, no work to recompute).
ATEN_VIEW_OPS = frozenset({
    "view",
    "_unsafe_view",
    "_reshape_alias",
    "t",
    "transpose",
    "permute",
    "expand",
    "unsqueeze",
    "squeeze",
    "slice",
    "select",
    "narrow",
    "diagonal",
    "split",
    "split_with_sizes",
    "unbind",
    "chunk",
    "alias",
    "detach",
    "as_strided",
    "unfold",
    "view_as_real",
    "view_as_complex",
    "lift_fresh",
})

#: aten ops that allocate nothing (shape queries and assertions).
ATEN_NO_ALLOC = frozenset({
    "sym_size",
    "sym_stride",
    "sym_numel",
    "sym_storage_offset",
    "_assert_async",
    "_assert_scalar",
    "_assert_tensor_metadata",
})

#: aten op → the reference's ``kind`` (its jaxpr primitive name), so that a
#: torch twin of a JAX function hashes to the same ``graph_digest`` and
#: hits the same plans.  Ops not listed keep their own name.
ATEN_KINDS = {
    "mm": "dot_general",
    "bmm": "dot_general",
    "addmm": "dot_general",
    "convolution": "conv_general_dilated",
    FLASH_OP: "flash_attention",
    SHARD_OP: "sharding_constraint",
    "tanh": "tanh",
    "mul": "mul",
    "add": "add",
    "sub": "sub",
    "div": "div",
    "neg": "neg",
    "exp": "exp",
    "log": "log",
    "sin": "sin",
    "cos": "cos",
    "abs": "abs",
    "sqrt": "sqrt",
    "rsqrt": "rsqrt",
    "sigmoid": "logistic",
    "maximum": "max",
    "minimum": "min",
    "sum": "reduce_sum",
    "amax": "reduce_max",
    "amin": "reduce_min",
    "where": "select_n",
    "cat": "concatenate",
    "clone": "copy",
    "_to_copy": "convert_element_type",
    "topk": "top_k",
    "index": "gather",
    "index_put": "scatter-add",  # the MoE dispatch (accumulate=True), ``.at[].add``
}
