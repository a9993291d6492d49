"""The port's knob -> collective threading against the JAX package's, on the
CPU: twin of ``tests/test_dist_train.py``'s three cases, plus the
reference semantics the port copies.

* ``grad_reduce_for`` on ``_FakeMesh`` shapes, case for case with the JAX
  function (None or the callable, ``pod_wire``, ``compress``).
* ``pod_sync`` is a no-op without a pod axis.
* The compressed step (``grad_compress="int8"``) on (pod 2, data 4): loss
  within 1e-5 of JAX's compressed step, parameters within the JAX test's
  rtol 0.02 / atol 1e-4 of it and of precise, and within rtol 1e-5 / atol
  1e-7 of JAX's compressed step (the wire's scales are the JAX region's,
  one a stacked leaf); ``pod_sync`` exact, one fp32 pod all-reduce a
  leaf recorded (the JAX test's cache of its jitted sync has no
  counterpart: the port's sync traces nothing); and, where the JAX test reads the region's jaxpr, the port's
  ``WIRE`` record: under ``sync_period=4`` the region issues a ``data``
  collective and no ``pod`` one, under ``sync_period=1`` both.
* The reference semantics: JAX's step on the 8-device (pod, data) mesh
  under ``sync_period=4`` and under precise gives equal parameters within
  1e-6, because GSPMD reduces the gradients over the pods before the
  region; the port's steps do the same.

The JAX side of the step cases runs once in one 8-device subprocess
(``conftest.subproc``) that writes its arrays to an npz. Torch runs on
one thread (a module fixture)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.approx.knobs import ApproxKnobs as JaxKnobs
from repro.models import api as jax_api
from repro.train import step as jax_step
from repro_torch import configs as t_configs
from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.convert import jax_path, params_from_numpy
from repro_torch.dist import collectives
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import ParamTree
from repro_torch.train import optim
from repro_torch.train import step as step_mod

ARCH = "phi4-mini-3.8b-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


_CASES = [
    ("precise", {}, None),
    ("precise", {}, {"model": 4}),
    ("precise", {}, {"pod": 2, "data": 4}),
    ("gint8", dict(grad_compress="int8"), {"data": 2, "model": 4}),
    ("gint8", dict(grad_compress="int8"), {"pod": 2, "data": 4}),
    ("gint8/4", dict(grad_compress="int8", sync_period=4),
     {"pod": 2, "data": 4}),
    ("sync/2", dict(sync_period=2), {"pod": 2, "data": 4}),
    ("sync/2", dict(sync_period=2), {"pod": 2}),
]


def _selection(fn, knobs_cls, knobs, shape):
    r = fn(knobs_cls(**knobs), None if shape is None else _FakeMesh(shape))
    return None if r is None else (r.pod_wire, r.compress)


@pytest.mark.parametrize("name,knobs,shape", _CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in _CASES])
def test_grad_reduce_selection(name, knobs, shape):
    got = _selection(step_mod.grad_reduce_for, ApproxKnobs, knobs, shape)
    assert got == _selection(jax_step.grad_reduce_for, JaxKnobs, knobs,
                             shape)


def test_grad_reduce_selection_asserts():
    """The JAX test's assertions on the port."""
    pod = _FakeMesh({"pod": 2, "data": 4})
    podless = _FakeMesh({"data": 2, "model": 4})
    assert step_mod.grad_reduce_for(PRECISE, None) is None
    assert step_mod.grad_reduce_for(PRECISE, _FakeMesh({"model": 4})) is None
    r = step_mod.grad_reduce_for(PRECISE, pod)
    assert r is not None and r.pod_wire and not r.compress
    r = step_mod.grad_reduce_for(ApproxKnobs(grad_compress="int8"), podless)
    assert r is not None and not r.pod_wire and r.compress
    r = step_mod.grad_reduce_for(ApproxKnobs(grad_compress="int8"), pod)
    assert r.pod_wire and r.compress
    r = step_mod.grad_reduce_for(
        ApproxKnobs(grad_compress="int8", sync_period=4), pod)
    assert r is not None and not r.pod_wire


def test_pod_sync_noop_without_pod_axis():
    tree = ParamTree({"w": torch.ones(4, 4)})
    assert step_mod.pod_sync(tree, None) is tree
    assert step_mod.pod_sync(
        tree, make_mesh((2, 4), ("data", "model"), "cpu")) is tree


_JAX = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.approx.knobs import ApproxKnobs
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import api
from repro.train import optim, step as step_mod

out_path = %r
res = {}


def key(k):
    for a in ("key", "name", "idx"):
        if hasattr(k, a):
            return str(getattr(k, a))
    return str(k)


def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/".join(key(k) for k in path)] = np.asarray(leaf)


cfg = get_config("phi4-mini-3.8b-smoke")
params = api.init(cfg, jax.random.PRNGKey(0), jnp.float32)
opt = optim.init_opt(params)
tokens = np.random.default_rng(1).integers(
    0, cfg.vocab_size, (4, 33)).astype(np.int32)
batch = {"tokens": jnp.asarray(tokens)}
res["tokens"] = tokens
mesh = make_mesh((2, 4), ("pod", "data"))
for tag, knobs, m in (("ref", ApproxKnobs(), None),
                      ("gint8", ApproxKnobs(grad_compress="int8"), mesh),
                      ("mesh", ApproxKnobs(), mesh),
                      ("sync4", ApproxKnobs(sync_period=4), mesh)):
    step = step_mod.make_train_step(cfg, knobs, remat="none", mesh=m)
    if m is None:
        p, _, met = jax.jit(step)(params, opt, batch)
    else:
        with jax.set_mesh(m):
            p, _, met = jax.jit(step)(params, opt, batch)
    res[tag + "/loss"] = np.float32(met["loss"])
    save(tag + "/p/", p)
np.savez(out_path, **res)
print("JAXDONE")
"""


@pytest.fixture(scope="module")
def jax_side(subproc, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_dist_train")
    subproc(_JAX % str(d / "out.npz"), devices=8)
    return dict(np.load(d / "out.npz"))


def _jax_leaf(arrays, prefix, name, cfg):
    path, i = jax_path(name, cfg)
    a = arrays[prefix + "/".join(path)]
    return a if i is None else a[i]


_TREE = {}


def _port_step(arrays, knobs, mesh):
    """One port train step from the JAX-initialised weights on the JAX
    side's batch: (params by name, metrics)."""
    tcfg = t_configs.get_config(ARCH)
    if "tree" not in _TREE:
        jp = jax_api.init(jax_configs.get_config(ARCH),
                          jax.random.PRNGKey(0), jnp.float32)
        _TREE["tree"] = jax.tree.map(np.asarray, jp)
    params = params_from_numpy(_TREE["tree"], tcfg)
    step = step_mod.make_train_step(tcfg, knobs, remat="none", mesh=mesh)
    params, _, m = step(params, optim.init_opt(params),
                        {"tokens": torch.from_numpy(arrays["tokens"])})
    return params, m


def test_compressed_grad_step_matches_jax(jax_side):
    arrays = jax_side
    cfg = t_configs.get_config(ARCH)
    mesh = make_mesh((2, 4), ("pod", "data"), "cpu")
    knobs = ApproxKnobs(grad_compress="int8")
    params, m = _port_step(arrays, knobs, mesh)
    # the loss comes before the region: equal to JAX's
    np.testing.assert_allclose(float(m["loss"]), arrays["gint8/loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), arrays["ref/loss"],
                               rtol=1e-5)
    for name, p in params.named_parameters():
        got = p.detach().numpy()
        for tag in ("gint8", "ref"):
            np.testing.assert_allclose(
                got, _jax_leaf(arrays, tag + "/p/", name, cfg), rtol=0.02,
                atol=1e-4, err_msg=f"{tag} {name}")
        # the wire takes one scale a stacked leaf, as JAX's region does:
        # the update is JAX's compressed one, not only within its noise
        np.testing.assert_allclose(
            got, _jax_leaf(arrays, "gint8/p/", name, cfg), rtol=1e-5,
            atol=1e-7, err_msg=name)

    # the periodic sync is exact on parameters every pod holds alike (the
    # JAX test's cache of its jitted sync has no counterpart: the port's
    # sync traces nothing); it records one fp32 pod all-reduce a leaf
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    mark = collectives.WIRE.mark()
    assert step_mod.pod_sync(params, mesh) is params
    assert collectives.WIRE.since(mark) == {("pod", "all_reduce"): (
        len(before), sum(p.numel() * 4 for p in before.values()))}
    for k, p in params.named_parameters():
        torch.testing.assert_close(p.detach(), before[k], rtol=1e-6, atol=0)

    # the region's collectives: sync_period 1 carries both axes, 4 no pod
    grads = {k: torch.zeros_like(p) for k, p in params.named_parameters()}
    r1 = step_mod.grad_reduce_for(knobs, mesh)
    r4 = step_mod.grad_reduce_for(
        ApproxKnobs(grad_compress="int8", sync_period=4), mesh)
    for r, axes in ((r1, {"pod", "data"}), (r4, {"data"})):
        mark = collectives.WIRE.mark()
        r(grads)
        calls = collectives.WIRE.since(mark)
        assert {axis for axis, _ in calls} == axes
        assert {c for axis, c in calls if axis == "data"} == {"all_reduce"}
    # the int8 wire: a pod payload a quarter of the fp32 all-reduce's
    mark = collectives.WIRE.mark()
    step_mod.grad_reduce_for(PRECISE, mesh)(grads)
    fp32 = collectives.WIRE.by_axis(mark)["pod"]
    mark = collectives.WIRE.mark()
    r1(grads)
    int8 = collectives.WIRE.by_axis(mark)["pod"]
    assert 0.25 <= int8 / fp32 < 0.26


def test_compressed_region_is_the_quantised_mean():
    """On gradients every position holds alike, the compressed region is
    each leaf's int8 round trip (per-tensor absmax / 127, round half to
    even), and the full-precision region is exact."""
    mesh = make_mesh((2, 4), ("pod", "data"), "cpu")
    g = torch.Generator().manual_seed(3)
    grads = {"a": torch.randn(6, 10, generator=g),
             "b": torch.randn(7, generator=g) * 1e-3}
    got = collectives.grad_sync(grads, mesh, compress=True)
    for k, x in grads.items():
        q, s = collectives._quantize_int8(x)
        torch.testing.assert_close(got[k], q.float() * s, rtol=0, atol=0)
    exact = collectives.grad_sync(grads, mesh)
    for k, x in grads.items():
        torch.testing.assert_close(exact[k], x, rtol=0, atol=0)
    q, _ = collectives._quantize_int8(torch.tensor([0.5, 1.5, 2.5, 127.0]))
    assert q.tolist() == [0, 2, 2, 127]


def test_sync_elision_is_the_reference_semantics(jax_side):
    """JAX's step on (pod 2, data 4): sync_period 4 and precise give the
    same parameters within 1e-6 (GSPMD has reduced the gradients over the
    pods before the region, so dropping the owned pod collective changes
    nothing); the port's steps agree, and with JAX's."""
    arrays = jax_side
    cfg = t_configs.get_config(ARCH)
    keys = [k for k in arrays if k.startswith("mesh/p/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(arrays["sync4/p/" + k[7:]], arrays[k],
                                   rtol=1e-6, atol=0)
    mesh = make_mesh((2, 4), ("pod", "data"), "cpu")
    p4, m4 = _port_step(arrays, ApproxKnobs(sync_period=4), mesh)
    p1, m1 = _port_step(arrays, PRECISE, mesh)
    assert float(m4["loss"]) == float(m1["loss"])
    for (name, a), (_, b) in zip(p4.named_parameters(),
                                 p1.named_parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
        np.testing.assert_allclose(
            a.detach().numpy(), _jax_leaf(arrays, "sync4/p/", name, cfg),
            rtol=5e-3, atol=5e-4, err_msg=name)


def test_train_driver_pod_mesh_chaos(capsys):
    """``launch/train.py --pod-mesh --positions 4 --chaos
    "revoke@3:2,restore@6"`` on the CPU: the mesh shrinks to (1, 2) at
    step 3 and grows back at 6 (params and AdamW state restaged, the
    steps rebuilt), printing the JAX driver's ``chaos:`` lines, and its
    losses equal the unfaulted single-device run's within 1e-6: the layout
    changes no number."""
    from repro_torch.launch import train as t_train
    argv = ["--device", "cpu", "--steps", "8", "--batch", "4", "--seq", "16"]
    faulted = t_train.main(argv + ["--pod-mesh", "--positions", "4",
                                   "--chaos", "revoke@3:2,restore@6"])
    plain = t_train.main(argv)
    text = capsys.readouterr().out
    assert "chaos: 2 scripted capacity events" in text
    assert "chaos@3: revoke count=2" in text
    assert [r["mesh"] for r in faulted["rehomes"]] == ["1x2", "2x2"]
    assert dict(faulted["mesh"].shape) == {"pod": 2, "data": 2}
    np.testing.assert_allclose(faulted["losses"], plain["losses"],
                               rtol=1e-6)
