"""The port's sharding rules and specs against the reference's, as data:
for every config, on the production meshes' axis sizes, with the default
rules and with the dry-run's serving overrides, ``param_specs`` and
``cache_specs`` equal the reference's ``PartitionSpec``s exactly. No
mesh is needed for that. Also ``logical_batch_spec``, the spec's DTensor
placements, the rest of ``sharding_ctx`` (``axis_size``, ``hint`` outside
and inside a context) and ``launch/mesh.py``. ``repro.launch.dryrun`` is
not imported: importing it sets ``XLA_FLAGS`` to 512 host devices."""

import types

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import REGISTRY
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import param as jparam
from repro.models import sharding_ctx as jctx
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.models import param as tparam
from repro_torch.models import sharding_ctx as tctx
from torch_dist_ranks import one_rank_mesh

ARCHS = sorted(REGISTRY)
MESHES = {"pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}
# the dry-run's rule sets (src/repro/launch/dryrun.py::rules_for): the
# default; decode serving; decode with 2-D expert parallelism; batch 1
OVERRIDES = {
    "default": {},
    "decode": {"kv_seq": ("model",), "embed": (), "embed_pod": ()},
    "decode_ep2d": {"kv_seq": ("model",), "embed": (), "embed_pod": (),
                    "expert": ("data", "model")},
    "long": {"batch": (), "kv_seq": ("data", "model"), "embed": (),
             "embed_pod": ()},
}
CACHE_SHAPES = [(128, 32768), (1, 4096)]


def _rules(pkg, name):
    return pkg.ShardingRules().with_overrides(**OVERRIDES[name])


def _as_data(tree):
    """Specs as nested tuples (the reference's ``P`` and the port's
    ``PartitionSpec`` both iterate their entries)."""
    if isinstance(tree, dict):
        return {k: _as_data(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("rules", sorted(OVERRIDES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_reference(arch, mesh, rules):
    ms = MESHES[mesh]
    ref, port = ref_build(ref_config(arch)), build_model(get_config(arch))
    jr, tr = _rules(jparam, rules), _rules(tparam, rules)
    assert tr == tparam.ShardingRules(jr.rules)
    want = _as_data(ref.param_specs(jr, ms))
    got = port.param_specs(tr, ms)
    assert _as_data(got) == want
    assert all(isinstance(s, tparam.PartitionSpec)
               for s in tparam.tree_leaves(got))
    for batch, skv in CACHE_SHAPES:
        assert _as_data(port.cache_specs(batch, skv, tr, ms)) == \
            _as_data(ref.cache_specs(batch, skv, jr, ms))


@pytest.mark.parametrize("shape", [None, (256, 4096, 2048), (3, 5, 7)])
@pytest.mark.parametrize("axes", [("batch", "seq", None),
                                  ("batch", "seq", "vocab"),
                                  ("batch", "kv_seq", "kv_heads")])
def test_logical_batch_spec_matches_reference(axes, shape):
    for ms in MESHES.values():
        for name in OVERRIDES:
            want = jparam.logical_batch_spec(axes, _rules(jparam, name), ms,
                                             shape)
            got = tparam.logical_batch_spec(axes, _rules(tparam, name), ms,
                                            shape)
            assert tuple(got) == tuple(want)


def test_spec_placements():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    P = tparam.PartitionSpec
    assert tparam.placements(P(None, ("pod", "data"), "model"), mesh) == [
        Shard(1), Shard(1), Shard(2)]
    assert tparam.placements(P(), mesh) == [Replicate()] * 3
    assert tparam.placements(P("data", None), mesh) == [
        Replicate(), Shard(0), Replicate()]
    with pytest.raises(ValueError, match="out of the mesh's order"):
        tparam.placements(P(("model", "data")), mesh)
    assert P("a", None) == ("a", None) and repr(P("a")) == \
        "PartitionSpec('a',)"


def test_axis_size_matches_reference():
    for ms in MESHES.values():
        for name in OVERRIDES:
            for logical in ("batch", "heads", "kv_seq", "expert", "embed",
                            "layers", "missing"):
                assert tctx.axis_size(logical) == jctx.axis_size(logical) \
                    == 1
                with tctx.axis_rules(_rules(tparam, name), ms), \
                        jctx.axis_rules(_rules(jparam, name), ms):
                    assert tctx.axis_size(logical) == \
                        jctx.axis_size(logical)


def test_hint_outside_a_context_and_on_plain_tensors_is_a_no_op():
    x = torch.ones((4, 6, 8))
    assert tctx.hint(x, "batch", "seq", None) is x
    assert tctx.hint(x, "batch") is x          # no context: not checked
    with tctx.axis_rules(tparam.ShardingRules(), MESHES["pod"]):
        assert tctx.hint(x, "batch", "seq", None) is x
        with pytest.raises(ValueError, match="hint axes"):
            tctx.hint(x, "batch", None)
    tree = {"a": x, "b": {"c": torch.zeros(2, 3)}}
    out = tctx.hint_tree(tree, lambda leaf: (None,) * leaf.ndim)
    assert out["a"] is x and out["b"]["c"] is tree["b"]["c"]


def test_hint_redistributes_a_dtensor():
    with one_rank_mesh() as mesh:
        x = DTensor.from_local(torch.arange(8.).reshape(4, 2), mesh,
                               [Replicate(), Replicate()])
        with tctx.axis_rules(tparam.ShardingRules(),
                             tctx.mesh_shape_dict(mesh)):
            y = tctx.hint(x, "batch", "vocab")
        assert list(y.placements) == [Shard(0), Shard(1)]
        assert torch.equal(y.full_tensor(), x.full_tensor())


def test_meshes():
    assert tmesh.PRODUCTION_MESHES == {
        False: ((16, 16), ("data", "model")),
        True: ((2, 16, 16), ("pod", "data", "model"))}
    for multi_pod, ms in ((False, MESHES["pod"]),
                          (True, MESHES["multi_pod"])):
        shape, axes = tmesh.PRODUCTION_MESHES[multi_pod]
        assert dict(zip(axes, shape)) == ms
    assert tmesh.backend_for("cpu") == "gloo"
    assert tmesh.backend_for("cuda") == "nccl"
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_host_mesh(1, 1, device="cpu")
    with one_rank_mesh() as mesh:
        assert tmesh.mesh_shape_dict(mesh) == {"data": 1, "model": 1}
        assert mesh.device_type == "cpu"
        with pytest.raises(ValueError, match="needs 2 ranks"):
            tmesh.make_host_mesh(2, 1, device="cpu")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            tmesh.make_production_mesh(device="cpu")


def test_shard_map_runs_on_local_blocks():
    """``shard_map`` on a (1,1) mesh: a plain input cut to the rank's
    block (here the whole), a DTensor redistributed, outputs wrapped
    under their specs."""
    P = tparam.PartitionSpec
    with one_rank_mesh() as mesh:
        x = torch.arange(12.).reshape(3, 4)
        d = DTensor.from_local(torch.ones(3, 4), mesh,
                               [Replicate(), Replicate()])

        def body(a, b):
            return a + b, tctx.psum(a.sum(), mesh, "model")

        out, total = tctx.shard_map(body, mesh, (P("data", None), P()),
                                    (P("data", "model"), P()))(x, d)
        assert list(out.placements) == [Shard(0), Shard(1)]
        assert torch.equal(out.full_tensor(), x + 1)
        assert float(total.full_tensor()) == float(x.sum())
