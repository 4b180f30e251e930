"""The port's mesh layer against the reference's, in-process and with no
process group beyond a world of one: ``launch.mesh`` (parse, clamp,
placement-fallback warnings), the placement and sharding specs
(``core.layers``, ``models.lm``, ``models.attention``, ``models.moe``)
leaf by leaf against the reference's ``PartitionSpec``s (pure functions of
shapes; the reference's ``constrained_sharding`` is given a jax
``AbstractMesh``), the layout step on a stand-in mesh, and the MoE
dispatch's pack and unpack against the reference's on one routing with
overflow.  The cross-rank runs are in test_torch_sharded.py."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import layers as tl
from repro_torch.core.placement import LayerPlacement
from repro_torch.launch import mesh as tmesh
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.core import layers as rl  # noqa: E402
from repro.core.placement import LayerPlacement as RLayerPlacement  # noqa: E402

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

ARCHS = ("rwkv6-7b", "qwen2-72b", "phi3.5-moe-42b-a6.6b")


@pytest.fixture
def world():
    """A test that starts a world of one tears it down after."""
    yield
    tmesh.destroy_world()


# -- launch/mesh.py ------------------------------------------------------------------
def test_parse_mesh():
    assert tmesh.parse_mesh("2,4") == (2, 4)
    assert tmesh.parse_mesh("1,1") == (1, 1)


@pytest.mark.parametrize("bad", ["", "2", "2x4", "0,4", "a,b"])
def test_parse_mesh_refuses(bad):
    with pytest.raises(ValueError):
        tmesh.parse_mesh(bad)


def test_make_host_mesh_warns_on_clamp(world):
    with pytest.warns(UserWarning, match="clamped"):
        mesh = tmesh.make_host_mesh(data=2, model=4, device="cpu")
    assert tl.axis_sizes(mesh) == {"data": 1, "model": 1}
    assert torch.distributed.get_backend() == "gloo"
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no warning when it fits
        mesh = tmesh.make_host_mesh(data=1, model=1, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")


def test_resolve_mesh_without_a_world_is_one_device():
    assert tmesh.resolve_mesh("", None, "cpu") is None
    assert tmesh.resolve_mesh(None, None, "cpu") is None
    assert not torch.distributed.is_initialized()


def test_mesh_for_plan_warns_on_placement_fallback(world):
    from repro_torch.pim.plan import auto_plan
    plan = auto_plan("rwkv6-7b-smoke", target_cr=2.0, weight_bits=3, mode="kernel")
    # 'pod' is a legal axis name but absent from the (data, model) mesh
    plan = dataclasses.replace(plan, layers=[dataclasses.replace(
        plan.layers[0], placement=LayerPlacement(row_axis=None, col_axis="pod"))]
        + list(plan.layers[1:]))
    with pytest.warns(UserWarning, match="absent from mesh"):
        tmesh.mesh_for_plan(plan, data=1, model=1, device="cpu")


def test_card_constants_are_the_h100s():
    from repro_torch.kernels import cost
    assert cost.BF16_TC_FLOPS == 989e12 and cost.HBM_BW == 3.35e12
    assert cost.HBM_BYTES == 80 * 2**30 and cost.NVLINK_BW == 900e9
    assert cost.IB_BW == 50e9


# -- core/layers.py: placement specs and the divisibility snap -------------------------
PLACEMENTS = [None, (None, "model", "replicate"), ("data", "model", "shard"),
              (None, "data", "shard"), ("model", None, "replicate")]


@pytest.mark.parametrize("pl", PLACEMENTS, ids=str)
def test_placement_pspec_matches_reference(pl):
    tp = None if pl is None else LayerPlacement(*pl)
    rp = None if pl is None else RLayerPlacement(*pl)
    for leaf in ("E", "W", "Eq", "Es", "Ez", "b", "mu"):
        for ndim in (1, 2, 3):
            assert tl.placement_pspec(tp, leaf, ndim) == tuple(rl.placement_pspec(rp, leaf, ndim))


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 1), (8, 1)], ids=str)
def test_constrained_sharding_matches_reference(mesh_shape):
    sizes = dict(zip(("data", "model"), mesh_shape))
    amesh = AbstractMesh(mesh_shape, ("data", "model"))
    cases = [(("data", "model"), (4, 8)), (("data", "model"), (6, 6)),
             ((None, "model"), (3, 12)), ((("data", "model"), None), (16, 2)),
             ((("pod", "data"), "model"), (8, 4)), (("pod", None), (4, 4)),
             ((None, None, "model"), (2, 3, 5)), (("model", "data"), (7, 8))]
    for spec, shape in cases:
        want = tuple(rl.constrained_sharding(amesh, P(*spec), shape).spec)
        want += (None,) * (len(shape) - len(want))
        assert tl.constrained_sharding(sizes, spec, shape) == want, (spec, shape)


class _FakeMesh:
    """The layout step's view of a mesh: names, sizes, this rank's coordinates."""

    def __init__(self, shape, coords):
        self.mesh_dim_names, self.shape, self.coords = ("data", "model"), shape, coords

    def get_local_rank(self, axis):
        return self.coords[self.mesh_dim_names.index(axis)]


def test_distribute_takes_this_ranks_block():
    t = torch.arange(8 * 12).reshape(8, 12)
    blocks = {}
    for d in range(2):
        for m in range(4):
            s = tl.distribute(t, ("data", "model"), _FakeMesh((2, 4), (d, m)))
            assert s.is_split() and s.local.shape == (4, 3) and s.shape == t.shape
            blocks[d, m] = s.local
    whole = torch.cat([torch.cat([blocks[d, m] for m in range(4)], 1) for d in range(2)], 0)
    assert torch.equal(whole, t)
    # a dim over two axes: the first axis major
    s = tl.distribute(t, (("data", "model"), None), _FakeMesh((2, 4), (1, 2)))
    assert torch.equal(s.local, t[6:7])
    # every axis of size 1: the whole tensor itself, no copy, and full() is it
    one = tl.distribute(t, ("data", "model"), _FakeMesh((1, 1), (0, 0)))
    assert not one.is_split() and one.local is t and one.full() is t
    # a replicated spec leaves a plain tensor
    assert tl.lay_out(t, (None, None), _FakeMesh((2, 4), (0, 0))) is t


def test_param_count_counts_laid_out_leaves_whole():
    t = torch.zeros(8, 12)
    tree = {"a": t, "g": [{"w": tl.distribute(t, ("data", "model"), _FakeMesh((2, 4), (0, 1)))}]}
    assert tl.param_count(tree) == 2 * 96


# -- models/lm.py, attention.py, moe.py: spec trees ------------------------------------
def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P) and not (
            tree and (tree[0] is None or isinstance(tree[0], (str, tuple)))):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _port_vs_ref(port_specs, ref_specs, group_key):
    """Every port leaf's spec against the reference's at the same path; a
    group leaf's against the reference's minus its leading group axis."""
    ref = {p: tuple(s) for p, s in _walk(ref_specs)}
    seen = set()
    for path, spec in _walk(port_specs):
        parts = path.split("/")
        if parts[1] == group_key:               # /groups/<g>/... -> /groups/...
            rpath = "/".join(parts[:2] + parts[3:])
            want = ref[rpath][1:]
        else:
            rpath, want = path, ref[path]
        want = want + (None,) * (len(spec) - len(want))
        assert spec == want, (path, spec, want)
        seen.add(rpath)
    assert seen == set(ref)
    return len(seen)


def _plans(arch):
    """A searched-shape plan for '<arch>-smoke' in both packages: the
    port's auto plan, legalized for a (2, 4) mesh, saved and loaded by the
    reference (one JSON format)."""
    from repro.pim.plan import EpitomePlan as REpitomePlan
    from repro_torch.pim.plan import auto_plan, legalize_plan
    plan = legalize_plan(auto_plan(f"{arch}-smoke", target_cr=2.0, weight_bits=3,
                                   mode="kernel"), mesh_shape={"data": 2, "model": 4})
    return plan, REpitomePlan.from_json(plan.to_json())


@pytest.fixture(scope="module")
def trees():
    """(arch, planned) -> (port cfg, port params, reference cfg, reference
    params' shapes), prepacked kernel-q3 smoke models."""
    from repro.configs import get_smoke_config as rsmoke
    from repro.models import lm as rlm
    from repro_torch.configs import get_smoke_config as tsmoke
    from repro_torch.models import lm as tlm
    out = {}
    for arch in ARCHS:
        for planned in (False, True):
            if planned:
                tplan, rplan = _plans(arch)
                tc, rc = tsmoke(arch, plan=tplan), rsmoke(arch, plan=rplan)
            else:
                tc, rc = tsmoke(arch, "kernel-q3"), rsmoke(arch, "kernel-q3")
            tp = tlm.prepack_params(tlm.init_params(torch.Generator().manual_seed(0), tc,
                                                    "cpu"), tc)
            rp = jax.eval_shape(lambda: rlm.prepack_params(
                rlm.init_params(jax.random.PRNGKey(0), rc), rc))
            out[arch, planned] = (tc, tp, rc, rp)
    return out


@pytest.mark.parametrize("serving", [False, True], ids=["fsdp_tp", "serving"])
@pytest.mark.parametrize("planned", [False, True], ids=["no_plan", "plan"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(trees, arch, planned, serving):
    from repro.models import lm as rlm
    from repro_torch.models import lm as tlm
    tc, tp, rc, rp = trees[arch, planned]
    if planned:
        assert any(lc.placement is not None for _, lc in tc.layer_config)
    n = _port_vs_ref(tlm.param_specs(tc, tp, serving=serving),
                     rlm.param_specs(rc, rp, serving=serving), "groups")
    assert n > 10


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "qwen2-72b", "jamba-1.5-large-398b"])
def test_state_specs_match_reference(arch, batch):
    from repro.configs import get_smoke_config as rsmoke
    from repro.models import lm as rlm
    from repro_torch.configs import get_smoke_config as tsmoke
    from repro_torch.models import lm as tlm
    tc, rc = tsmoke(arch), rsmoke(arch)
    ts = tlm.init_decode_state(tc, batch, 17, "cpu")
    rs = jax.eval_shape(lambda: rlm.init_decode_state(rc, batch, 17))
    ref = {p: tuple(s) for p, s in _walk(rlm.state_specs(rc, rs, batch))}
    port = dict(_walk(tlm.state_specs(tc, ts, batch)))
    assert port
    for path, spec in port.items():
        rpath = "/" + "/".join(path.split("/")[2:])         # /<g>/L0/s -> /L0/s
        assert spec == ref[rpath][1:], (path, spec, ref[rpath])


def test_kv_cache_and_moe_param_specs_match_reference():
    from repro.configs import get_smoke_config as rsmoke
    from repro.models import attention as ra
    from repro.models import moe as rmoe
    from repro_torch.configs import get_smoke_config as tsmoke
    from repro_torch.models import attention as ta
    for b, s in ((("pod", "data"), "model"), (None, ("pod", "data", "model")), (None, None)):
        assert ta.kv_cache_spec(b, s) == tuple(ra.kv_cache_spec(b, s))[1:]
    arch = "phi3.5-moe-42b-a6.6b"
    assert ({k: tuple(v) for k, v in rmoe.moe_param_specs(rsmoke(arch)).items()}
            == tmoe.moe_param_specs(tsmoke(arch)))


def test_clean_spec_and_shard_without_and_with_a_mesh():
    t = torch.zeros(8, 4)
    assert tcommon.get_mesh() is None
    assert tcommon.shard(t, "data", "model") is t             # no mesh: the identity
    assert tcommon.clean_spec(("pod", "data"), "model", None) == (None, None, None)
    tcommon.set_mesh(_FakeMesh((2, 1), (1, 0)))
    try:
        assert tcommon.clean_spec(("pod", "data"), "model", None) == (("data",), "model", None)
        s = tcommon.shard(t, tcommon.BATCH_AXES, tcommon.TENSOR_AXIS)
        assert isinstance(s, tl.Sharded) and s.spec == ("data", "model")
        assert torch.equal(s.local, t[4:])
    finally:
        tcommon.set_mesh(None)
    assert tcommon.batch_spec(2) == (("pod", "data"), None, None)


# -- models/moe.py: the dispatch's pack and unpack --------------------------------------
@pytest.mark.parametrize("n_dest,cap,E", [(4, 3, 2), (4, 8, 4), (2, 2, 2)])
def test_local_pack_unpack_match_reference(n_dest, cap, E):
    """Slots, destinations and drops equal the reference's on one routing
    (``cap`` 3 with 16 tokens x top-2 over 2 experts overflows)."""
    from repro.models import moe as rmoe
    T, d, k = 16, 8, 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, d)).astype(np.float32)
    experts = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    w = rng.random((T, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    repl = max(1, n_dest // E)
    rbuf, rinfo = rmoe._local_pack(jnp.asarray(x), jnp.asarray(w), jnp.asarray(experts),
                                   n_dest, cap, repl, E)
    tbuf, tinfo = tmoe._local_pack(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(experts).long(), n_dest, cap, repl, E)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(rbuf))
    for name, a, b in zip(("flat_t", "flat_w", "dest", "slot", "ok"), tinfo, rinfo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    dropped = int((~tinfo[4]).sum())
    if (n_dest, cap, E) == (4, 3, 2):
        assert dropped > 0
    recv = rng.standard_normal((n_dest, cap, d)).astype(np.float32)
    ry = rmoe._local_unpack(jnp.asarray(recv), rinfo, T, d)
    ty = tmoe._local_unpack(torch.from_numpy(recv), tinfo, T, d)
    assert ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=1e-6, atol=1e-6)


def test_moe_ffn_chooses_dense_without_dispatchable_mesh():
    """With no mesh, or a data size the experts do not divide, the dense
    path (no collective is touched)."""
    from repro_torch.configs import get_smoke_config as tsmoke
    cfg = tsmoke("phi3.5-moe-42b-a6.6b")
    params = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn(8, 4, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(cfg.cdtype)
    dense = tmoe.moe_dense(params, x, cfg)
    assert torch.equal(tmoe.moe_ffn(params, x, cfg), dense)
    tcommon.set_mesh(_FakeMesh((3, 1), (0, 0)))     # 3 % 4 experts != 0
    try:
        assert torch.equal(tmoe.moe_ffn(params, x, cfg), dense)
    finally:
        tcommon.set_mesh(None)
