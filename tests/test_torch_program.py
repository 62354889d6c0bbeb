"""The port's StepProgram IR against the JAX package's, pure Python.

* ``regime_rounds``, ``pick_row_flavor``, ``build_program`` (regime,
  axes, shards, rounds, layouts, schedule), ``collective_counts`` and
  ``collective_wire_bytes`` equal ``repro.core.program``'s over a grid of
  leaf shapes and group sizes, for every combination of step kind,
  recovery, grad-fused tap, refresh method, row-state flavour and spec
  (column, row, replicated).  The JAX side plans on an ``AbstractMesh``
  of shape (1, g); the port's on an abstract ``MeshContext`` of the same
  shape.
* ``hotpath_param_specs`` on llama-7b's and llama-1b's leaf shapes, at
  ranks 512 and 1024, for every ``--hotpath-layout`` but off, on the
  (1, 8) host mesh and the (16, 16) production mesh, equals the JAX
  package's leaf for leaf.
* The plan's spec helpers and ``bucket_key`` agree with the JAX
  package's.
"""

import itertools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs.registry import get_config as jax_get_config
from repro.core import plan as jplan
from repro.core import program as jprogram
from repro.core.subtrack import LowRankConfig as JLowRankConfig
from repro.distributed import sharding as jsharding
from repro.distributed.context import MeshContext as JMeshContext
from repro_torch.core import plan as tplan
from repro_torch.core import program as tprogram
from repro_torch.core.subtrack import LowRankConfig
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.context import abstract_context
from torch_threads import one_thread  # noqa: F401


SHAPES = [(256, 512, 8), (96, 200, 16), (512, 512, 64),
          (4096, 11008, 1024), (2048, 32000, 512)]
GROUPS = [1, 2, 4, 8]
METHODS = ("grassmann", "none", "svd", "grass")
ROW_STATES = ("auto", "replicated", "reduce-scatter")


def _program_fields(prog) -> tuple:
    rounds = tuple((r.name, r.kind, r.rows, r.cols, r.dtype_bytes)
                   for r in prog.rounds)
    return (prog.regime, tuple(prog.axes), prog.shards, prog.m, prog.n,
            prog.rank, prog.tracking, prog.tracks, prog.recovery, rounds,
            prog.grad_layout, prog.state_layout, prog.schedule,
            prog.collective_counts(), prog.collective_wire_bytes())


@pytest.mark.parametrize("m,n,r", SHAPES)
@pytest.mark.parametrize("g", GROUPS)
def test_program_ir_matches_the_jax_package(m, n, r, g):
    jmesh = AbstractMesh((1, g), ("data", "model"))
    tmesh = abstract_context((1, g))
    for regime in jprogram.REGIMES:
        for tracking, recovery, tapped in itertools.product(
                (False, True), repeat=3):
            want = jprogram.regime_rounds(regime, m, n, r, g,
                                          tracking=tracking,
                                          recovery=recovery, tapped=tapped)
            got = tprogram.regime_rounds(regime, m, n, r, g,
                                         tracking=tracking,
                                         recovery=recovery, tapped=tapped)
            assert [tuple(vars(x).values()) for x in got] == \
                [tuple(vars(x).values()) for x in want]
    for row_state in ROW_STATES:
        assert tprogram.pick_row_flavor(m, n, r, g, row_state) == \
            jprogram.pick_row_flavor(m, n, r, g, row_state)
    specs = {"column": (None, "model"), "row": ("model", None),
             "replicated": None, "lead": ("model", None, None)}
    cases = itertools.product(specs, METHODS, ROW_STATES, (False, True),
                              (False, True), (False, True), (0, 2))
    for spec, method, row_state, tracking, recovery, tapped, reorth in cases:
        kw = dict(rank=r, method=method, recovery=recovery,
                  use_kernels=True, row_state=row_state,
                  reorth_interval=reorth)
        shape = (3, m, n) if spec == "lead" else (m, n)
        jspec = None if specs[spec] is None else P(*specs[spec])
        jp = jplan.plan_for_shape(shape, r, spec=jspec)
        tp = tplan.plan_for_shape(shape, r, spec=specs[spec])
        assert tp.spec == (None if jp.spec is None else tuple(jp.spec))
        want = jprogram.build_program(jp, JLowRankConfig(**kw), jmesh,
                                      tracking=tracking, tapped=tapped)
        got = tprogram.build_program(tp, LowRankConfig(**kw), tmesh,
                                     tracking=tracking, tapped=tapped)
        assert _program_fields(got) == _program_fields(want), \
            (spec, method, row_state, tracking, recovery, tapped, reorth)
        assert tprogram.descriptor_for(tp, LowRankConfig(**kw), tmesh) \
            .to_dict() == jprogram.descriptor_for(
                jp, JLowRankConfig(**kw), jmesh).to_dict()


def _leaf_shapes(arch: str) -> dict:
    """The port's parameter tree of ``arch`` as shapes (init_decoder's
    structure), without allocating the weights."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    L, d, hd, ff, V = (cfg.n_layers, cfg.d_model, cfg.hd, cfg.d_ff,
                       cfg.padded_vocab)
    return {"embed": (V, d),
            "layers": {"ln1": (L, d), "ln2": (L, d),
                       "attn": {"wq": (L, d, cfg.n_heads * hd),
                                "wk": (L, d, cfg.n_kv_heads * hd),
                                "wv": (L, d, cfg.n_kv_heads * hd),
                                "wo": (L, cfg.n_heads * hd, d)},
                       "mlp": {"w_gate": (L, d, ff), "w_up": (L, d, ff),
                               "w_down": (L, ff, d)}},
            "final_norm": (d,), "lm_head": (d, V)}


def _tree(shapes, leaf):
    if isinstance(shapes, dict):
        return {k: _tree(v, leaf) for k, v in shapes.items()}
    return leaf(shapes)


@pytest.mark.parametrize("arch", ["llama-7b", "llama-1b"])
@pytest.mark.parametrize("rank", [512, 1024])
@pytest.mark.parametrize("mesh_shape", [(1, 8), (16, 16)])
def test_hotpath_param_specs_match_the_jax_package(arch, rank, mesh_shape):
    shapes = _leaf_shapes(arch)
    jctx = JMeshContext(mesh=AbstractMesh(mesh_shape, ("data", "model")))
    tctx = abstract_context(mesh_shape)
    jtree = _tree(shapes, lambda s: jax.ShapeDtypeStruct(s, jnp.bfloat16))
    ttree = _tree(shapes, lambda s: torch.empty(s, device="meta"))
    for layout in ("auto", "column", "row", "row-rs"):
        regimes = ("column", "row") if layout == "auto" else (layout,)
        row_state = "reduce-scatter" if layout == "row-rs" else "auto"
        want = jsharding.hotpath_param_specs(jtree, jctx, rank,
                                             regimes=regimes,
                                             row_state=row_state)
        got = tsharding.hotpath_param_specs(ttree, tctx, rank,
                                            regimes=regimes,
                                            row_state=row_state)
        flat_want = jax.tree.leaves(jax.tree.map(
            tuple, want, is_leaf=lambda x: isinstance(x, P)),
            is_leaf=lambda x: isinstance(x, tuple))
        flat_got = _flatten_sorted(got)
        assert flat_got == flat_want, layout
        # and the programs the optimizer builds from them
        cfg = dict(rank=rank, use_kernels=True, row_state=row_state)
        jplans = jplan.make_plans(jtree, rank, specs=want)
        tplans = tplan.make_plans(ttree, rank, specs=got)
        jprogs = [jprogram.build_program(p, JLowRankConfig(**cfg),
                                         jctx.mesh, tracking=True)
                  for p in jax.tree.leaves(jplans, is_leaf=lambda x:
                                           isinstance(x, jplan.ParamPlan))]
        tprogs = [tprogram.build_program(p, LowRankConfig(**cfg), tctx,
                                         tracking=True)
                  for p in _flatten_sorted(tplans)]
        assert [_program_fields(p) for p in tprogs] == \
            [_program_fields(p) for p in jprogs]


def _flatten_sorted(tree) -> list:
    """Leaves in the JAX flatten order (dict keys sorted at every level)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_sorted(tree[k])]
    return [tree]


@pytest.mark.parametrize("spec", [None, ("model", None), (None, "model"),
                                  (("data", "model"), None),
                                  ("model", None, None), (None, None)])
@pytest.mark.parametrize("shape", [(64, 256), (256, 64), (2, 64, 256)])
def test_plan_spec_helpers_match_the_jax_package(spec, shape):
    if spec is not None and len(spec) > len(shape):
        spec = spec[1:]
    jp = jplan.plan_for_shape(shape, 16, spec=None if spec is None
                              else P(*spec))
    tp = tplan.plan_for_shape(shape, 16, spec=spec)
    for name in ("spec_lead_sharded", "spec_column_axes", "spec_row_axes",
                 "spec_regime"):
        assert getattr(tplan, name)(tp) == getattr(jplan, name)(jp), name
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        assert tplan.bucket_key(tp, tdt) == jplan.bucket_key(jp, jdt)
