"""The port's elastic serving against the JAX package's, on the CPU: twin of
``tests/test_elastic.py``'s 14 cases, plus a zamba2 retry case, a runtime
fan-out through the ``ServeTenant`` and a ``--chaos`` CLI smoke.

* The injector and ``CapacityEvent`` cases run the same scripts and seeds
  through both packages and require the same events.
* ``pick_revoked`` / ``surviving_mesh`` are held to JAX's on a grid of
  cases (the JAX test's, (pod, data) and (pod, data, model) meshes, and
  prefer-divisor variants). JAX needs forced host devices for its meshes,
  so its side runs in one 8-device subprocess (``conftest.subproc``) that
  prints JSON.
* The engine cases (collective retry, quota cut, revoke without a mesh,
  admission timeout, backoff) hold the port's greedy tokens to one JAX
  paged engine's on the same prompts (phi4-mini-3.8b-smoke, fp32, the JAX
  weights carried over through numpy); greedy streams do not depend on
  the slot a request lands in. The zamba2-2.7b-smoke retry case holds the
  Mamba rows' snapshot: ``mamba_decode`` advances the state in place, so a
  re-run step must start from the rows as they were.
* The headline case, ``revoke@4+2:2,restore@9`` on mesh 4x2: the port's
  faulted run equals the JAX single-device unfaulted engine token for
  token, and its log entries match the JAX test's assertions. The JAX test
  holds JAX's faulted 8-device run to that same reference, so no 8-device
  JAX engine runs here.

Torch runs on one thread (a module fixture); each JAX engine runs once a
file."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.dist import elastic as jax_elastic
from repro.models import api as jax_api
from repro.serve import engine as jax_engine
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_numpy
from repro_torch.dist import elastic
from repro_torch.dist.elastic import CapacityEvent, FaultInjector
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.serve import engine as t_engine

ARCH = "phi4-mini-3.8b-smoke"
SINGLE = dict(batch_slots=2, max_len=32, paged=True, page_size=4,
              prefill_chunk=4)
CHAOS = dict(batch_slots=4, max_len=32, paged=True, page_size=4,
             prefill_chunk=3)
CHAOS_SCRIPT = "revoke@4+2:2,restore@9"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS, _JAX = {}, {}


def model(arch=ARCH):
    """(port cfg, port params, JAX cfg, JAX params), made once a file."""
    if arch not in _MODELS:
        jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
        jp = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
        _MODELS[arch] = (tcfg, params_from_numpy(
            jax.tree.map(np.asarray, jp), tcfg), jcfg, jp)
    return _MODELS[arch]


def retry_prompts(vocab):
    rng = np.random.default_rng(2)
    return [list(map(int, rng.integers(1, vocab, 6))) for _ in range(3)]


def backoff_prompt(vocab):
    return list(map(int, np.random.default_rng(4).integers(1, vocab, 6)))


def chaos_prompts(vocab):
    rng = np.random.default_rng(11)
    return [list(map(int, rng.integers(1, vocab, 7))) for _ in range(8)]


def jax_streams(name):
    """Greedy streams of one JAX single-device paged engine, keyed by
    (prompt, max_new): "single" serves every single-device engine case's
    requests through ``SINGLE``, "chaos" the headline prompts through
    ``CHAOS``, "zamba" the retry prompts on zamba2-2.7b-smoke."""
    if name in _JAX:
        return _JAX[name]
    arch = "zamba2-2.7b-smoke" if name == "zamba" else ARCH
    tcfg, _, jcfg, jp = model(arch)
    v = tcfg.vocab_size
    if name == "chaos":
        work, kw = [(p, 6) for p in chaos_prompts(v)], CHAOS
    elif name == "zamba":
        work, kw = [(p, 5) for p in retry_prompts(v)], SINGLE
    else:
        work = ([(p, 5) for p in retry_prompts(v)]
                + [([5, 9, 2, 7], 4), ([3, 1, 4], 12),
                   (backoff_prompt(v), 5)])
        kw = SINGLE
    eng = jax_engine.ServeEngine(jcfg, params=jp, **kw)
    reqs = [jax_engine.Request(i, prompt=list(p), max_new=n)
            for i, (p, n) in enumerate(work)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    _JAX[name] = {(tuple(p), n): list(map(int, r.out))
                  for (p, n), r in zip(work, reqs)}
    return _JAX[name]


def port_engine(arch=ARCH, **kw):
    cfg, params, _, _ = model(arch)
    return t_engine.ServeEngine(cfg, params=params, device="cpu", **kw)


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out for r in reqs]


# ------------------------------------------------------------- injector --

SCRIPTS = ["revoke@20+5:2, restore@60, quota_cut@10:3, quota_restore@40, "
           "fail@15:2", "collective_failure@3:1,revoke@0:7",
           "restore@1,quota_restore@2,quota_cut@2:1,revoke@2+1:1"]


def _fields(ev):
    return (ev.kind, ev.step, ev.count, tuple(ev.devices), ev.quanta,
            ev.deadline_steps)


@pytest.mark.parametrize("script", SCRIPTS, ids=range(len(SCRIPTS)))
def test_parse_grammar(script):
    inj = FaultInjector.parse(script)
    ref = jax_elastic.FaultInjector.parse(script)
    assert [_fields(e) for e in inj._events] == \
        [_fields(e) for e in ref._events]
    assert inj.pending() == ref.pending()
    if script == SCRIPTS[0]:
        evs = {(e.kind, e.step): e for e in inj._events}
        r = evs[(elastic.REVOKE, 20)]
        assert r.count == 2 and r.deadline_steps == 5 and r.quanta == 0
        assert evs[(elastic.RESTORE, 60)].count == 0
        q = evs[(elastic.QUOTA_CUT, 10)]
        assert q.quanta == 3 and q.count == 0
        assert evs[(elastic.COLLECTIVE_FAILURE, 15)].count == 2
    with pytest.raises(AssertionError):
        FaultInjector.parse("explode@3")


def test_due_pops_in_step_then_schedule_order():
    def make(mod):
        e = mod.CapacityEvent
        return mod.FaultInjector([e(mod.RESTORE, 5),
                                  e(mod.REVOKE, 2, count=1),
                                  e(mod.QUOTA_CUT, 2, quanta=1)])
    inj, ref = make(elastic), make(jax_elastic)
    for step in (1, 4, 100, 200):
        got, want = inj.due(step), ref.due(step)
        assert [_fields(e) for e in got] == [_fields(e) for e in want]
        assert inj.pending() == ref.pending()
        if step == 4:
            assert [e.kind for e in got] == [elastic.REVOKE,
                                             elastic.QUOTA_CUT]
            assert inj.pending() == 1
    assert len(inj.delivered) == 3


@pytest.mark.parametrize("seed", [7, 8, 123])
def test_random_script_is_seed_deterministic(seed):
    kw = dict(n_rounds=3, max_step=50, n_devices=8, seed=seed)
    a = FaultInjector.random_script(**kw)
    b = FaultInjector.random_script(**kw)
    ref = jax_elastic.FaultInjector.random_script(**kw)
    assert a._events == b._events
    assert [_fields(e) for e in a._events] == \
        [_fields(e) for e in ref._events]
    assert a._events != FaultInjector.random_script(
        **dict(kw, seed=seed + 1))._events
    assert [e.kind for e in a._events] == \
        [elastic.REVOKE, elastic.RESTORE] * 3
    steps = [e.step for e in a._events]
    assert steps == sorted(steps)
    assert all(1 <= e.count <= 4 for e in a._events
               if e.kind == elastic.REVOKE)


def test_capacity_event_validation():
    with pytest.raises(AssertionError):
        CapacityEvent("nonsense", 0)
    with pytest.raises(AssertionError):
        CapacityEvent(elastic.REVOKE, -1)
    with pytest.raises(AssertionError):
        CapacityEvent(elastic.REVOKE, 0, deadline_steps=-1)
    assert elastic.KINDS == jax_elastic.KINDS
    assert elastic.PRESSURE_ON == jax_elastic.PRESSURE_ON
    assert elastic.PRESSURE_OFF == jax_elastic.PRESSURE_OFF
    assert elastic.BATCH_AXES == jax_elastic.BATCH_AXES


# ------------------------------------------------------- mesh shrinking --

# (shape, axes, revoked, prefer_divisor_of)
SHRINK_CASES = [((4, 2), ("data", "model"), r, p)
                for r in ([], [7], [6, 7], [5, 6, 7], [0], [3, 4],
                          list(range(1, 8)), list(range(2, 8)))
                for p in (0, 4, 8, 3)]
SHRINK_CASES += [((2, 4), ("pod", "data"), r, p)
                 for r in ([5, 6, 7], [7], [0, 1, 2, 3, 4]) for p in (0, 4)]
SHRINK_CASES += [((2, 2, 2), ("pod", "data", "model"), r, p)
                 for r in ([7], [4, 5, 6, 7], [6, 7], [2, 3, 4, 5, 6, 7])
                 for p in (0, 2, 4)]
SHRINK_CASES += [((8, 1), ("data", "model"), r, p)
                 for r in ([7], [5, 6, 7], [1, 2]) for p in (0, 6, 8)]
PICK_CASES = [((4, 2), ("data", "model"), c, a)
              for c, a in ((2, []), (1, [7]), (0, []), (3, [6, 7]),
                           (8, []), (2, [0, 1]))]

_JAX_MESH = """
import json
from repro.dist import elastic
from repro.launch.mesh import make_mesh

shrink, pick = json.loads(%r), json.loads(%r)
out = dict(shrink=[], pick=[])
for shape, axes, revoked, prefer in shrink:
    mesh = make_mesh(tuple(shape), tuple(axes))
    m, why = elastic.surviving_mesh(mesh, set(revoked),
                                    prefer_divisor_of=prefer)
    out["shrink"].append(None if m is None else dict(
        shape=dict(m.shape), ids=[int(d.id) for d in m.devices.ravel()],
        same=m is mesh, why=why))
    if m is None:
        out["shrink"][-1] = dict(none=why)
for shape, axes, count, already in pick:
    mesh = make_mesh(tuple(shape), tuple(axes))
    out["pick"].append(list(elastic.pick_revoked(mesh, count,
                                                 already=already)))
print("JAXMESH" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_mesh_side(subproc):
    out = subproc(_JAX_MESH % (json.dumps(SHRINK_CASES),
                               json.dumps(PICK_CASES)), devices=8)
    line = next(s for s in out.splitlines() if s.startswith("JAXMESH"))
    return json.loads(line[len("JAXMESH"):])


def test_surviving_mesh_policy(jax_mesh_side):
    """The JAX test's assertions on the port's meshes, and every case of
    the grid equal to JAX's: shape, position ids, reason."""
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    assert elastic.pick_revoked(mesh, 2) == (6, 7)
    assert elastic.pick_revoked(mesh, 1, already=(7,)) == (6,)
    assert elastic.pick_revoked(mesh, 0) == ()
    same, why = elastic.surviving_mesh(mesh, set())
    assert same is mesh and why == "nothing revoked"
    m, _ = elastic.surviving_mesh(mesh, {6, 7}, prefer_divisor_of=4)
    assert dict(m.shape) == {"data": 2, "model": 2}
    assert sorted(m.ids) == [0, 1, 2, 3] and m.device == mesh.device
    m2, _ = elastic.surviving_mesh(mesh, {6, 7})
    assert dict(m2.shape) == {"data": 3, "model": 2}
    m3, why3 = elastic.surviving_mesh(mesh, set(range(1, 8)))
    assert m3 is None and "pinned" in why3
    tm = make_mesh((2, 4), ("pod", "data"), "cpu")
    m4, _ = elastic.surviving_mesh(tm, {5, 6, 7})
    assert dict(m4.shape) == {"pod": 1, "data": 4}
    assert elastic.surviving_mesh(None, {1}) == (None, "no mesh to shrink")

    for case, want in zip(SHRINK_CASES, jax_mesh_side["shrink"]):
        shape, axes, revoked, prefer = case
        mesh = make_mesh(shape, axes, "cpu")
        m, why = elastic.surviving_mesh(mesh, set(revoked),
                                        prefer_divisor_of=prefer)
        if m is None:
            assert want == dict(none=why), case
            continue
        got = dict(shape=dict(m.shape), ids=list(m.ids), same=m is mesh,
                   why=why)
        assert got == want, (case, got, want)
    for case, want in zip(PICK_CASES, jax_mesh_side["pick"]):
        shape, axes, count, already = case
        got = elastic.pick_revoked(make_mesh(shape, axes, "cpu"), count,
                                   already=already)
        assert list(got) == want, case


def test_reshard_live_round_trip():
    tree = {"w": torch.arange(12.0).reshape(3, 4), "b": [torch.ones(4)],
            "n": 3}
    out = elastic.reshard_live(tree)
    assert torch.equal(out["w"], tree["w"]) and out["n"] == 3
    staged = elastic.host_stage(tree)
    assert staged["b"][0].device.type == "cpu"
    staged["w"].add_(1)                  # a copy: the source is untouched
    assert torch.equal(tree["w"], torch.arange(12.0).reshape(3, 4))


# ------------------------------------------ engine capacity actuations --

def _retry_run(arch, faults):
    eng = port_engine(arch, **SINGLE)
    reqs = [t_engine.Request(i, prompt=p, max_new=5) for i, p in
            enumerate(retry_prompts(eng.cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    while not eng.idle:
        if faults and eng.step_count == 3:
            eng.inject(CapacityEvent(elastic.COLLECTIVE_FAILURE, 0,
                                     count=2))
        eng.step()
    return eng, [r.out for r in reqs]


@pytest.mark.parametrize("arch,ref", [(ARCH, "single"),
                                      ("zamba2-2.7b-smoke", "zamba")])
def test_collective_failure_retries_preserve_tokens(arch, ref):
    """A re-run step commits the unfaulted run's tokens, which are the JAX
    engine's; on zamba2 the Mamba rows come back from the step's
    snapshot."""
    ref_eng, unfaulted = _retry_run(arch, False)
    eng, got = _retry_run(arch, True)
    want = jax_streams(ref)
    vocab = eng.cfg.vocab_size
    assert got == unfaulted == [want[(tuple(p), 5)]
                                for p in retry_prompts(vocab)]
    assert eng.stats["collective_retries"] == 2
    assert ref_eng.stats["collective_retries"] == 0
    assert any(e.get("kind") == elastic.COLLECTIVE_FAILURE
               for e in eng.elastic_log)
    eng.pool.assert_consistent()


def test_quota_cut_is_separate_from_reclaim_ledger():
    eng = port_engine(**SINGLE)
    pool = eng.pool
    base_limit = pool.limit
    eng.inject(CapacityEvent(elastic.QUOTA_CUT, 0, quanta=1))
    eng.step()                      # events apply at the step boundary
    assert pool.capacity_cut == 1 and pool.reclaimed == 0
    assert pool.limit == base_limit - pool.quantum
    assert pool.stats["capacity_cut_events"] == 1
    pool.set_reclaimed(1)
    assert pool.limit == base_limit - 2 * pool.quantum
    pool.set_reclaimed(0)
    eng.inject(CapacityEvent(elastic.QUOTA_RESTORE, 0))
    eng.step()
    assert pool.capacity_cut == 0 and pool.limit == base_limit
    r = t_engine.Request(0, prompt=[5, 9, 2, 7], max_new=4)
    assert _serve(eng, [r]) and r.done
    assert r.out == jax_streams("single")[((5, 9, 2, 7), 4)]
    pool.assert_consistent()


def test_revoke_without_mesh_is_pressure_only():
    eng = port_engine(batch_slots=2, max_len=32, paged=True, page_size=4)
    eng.inject(CapacityEvent(elastic.REVOKE, 0, count=1))
    r = t_engine.Request(0, prompt=[3, 1, 4], max_new=4)
    _serve(eng, [r])
    assert r.done and eng.stats["rehomes"] == 0
    assert r.out == jax_streams("single")[((3, 1, 4), 12)][:4]
    assert any(e.get("ignored") == "no mesh" for e in eng.elastic_log)


def test_admission_timeout_rejects_structurally():
    import time
    eng = port_engine(batch_slots=1, max_len=64, prefill_chunk=4,
                      admission_timeout_s=0.0005)
    first = t_engine.Request(0, prompt=[3, 1, 4], max_new=12)
    eng.submit(first)
    eng.step()                              # first occupies the only slot
    late = t_engine.Request(1, prompt=[2, 7, 1], max_new=4)
    eng.submit(late)
    time.sleep(0.002)
    eng.run()
    assert first.done and first.out == \
        jax_streams("single")[((3, 1, 4), 12)]
    assert late.rejected and not late.done and not late.out
    rej = late.rejection
    assert rej is not None and rej.uid == 1 and rej.waited_s > 0
    assert rej.queue_depth >= 1 and rej.step > 0
    assert eng.rejected == [late]
    assert eng.stats["admission_timeouts"] == 1
    assert all(r.done or r.rejected for r in (first, late))


def test_blocked_admission_backs_off_then_recovers():
    prompt = backoff_prompt(model()[0].vocab_size)
    ref_eng = port_engine(**SINGLE)
    ref = t_engine.Request(0, prompt=list(prompt), max_new=5)
    _serve(ref_eng, [ref])
    eng = port_engine(**SINGLE)
    eng.pool.set_capacity_cut(eng.pool.max_quanta + eng.pool.spec.usable)
    req = t_engine.Request(0, prompt=list(prompt), max_new=5)
    eng.submit(req)
    for _ in range(12):
        eng.step()
    assert not req.done and req.uid in eng._backoff
    assert eng.stats["backoff_skips"] > 0
    blocked = eng.pool.stats["blocked_admissions"]
    assert 0 < blocked < 12, blocked
    eng.inject(CapacityEvent(elastic.QUOTA_RESTORE, 0))
    eng.pool.set_capacity_cut(0)
    eng.run()
    assert req.done and req.out == ref.out == \
        jax_streams("single")[(tuple(prompt), 5)]
    assert req.uid not in eng._backoff


# ------------------------------------------------- runtime integration --

def test_capacity_pressure_forces_violation_arm():
    from repro_torch.approx.knobs import PRECISE, ApproxKnobs
    from repro_torch.core.controller import Action, ControllerConfig
    from repro_torch.core.monitor import LatencyMonitor
    from repro_torch.core.runtime import PliantRuntime
    from repro_torch.core.variants import Variant, VariantTable
    table = VariantTable([
        Variant(PRECISE, 1.0, 0.0),
        Variant(ApproxKnobs(matmul_precision="int8"), 0.7, 0.003)])
    monitor = LatencyMonitor(qos_target_s=1e9, min_samples=4)
    rt = PliantRuntime(table, monitor,
                       ControllerConfig(decision_interval_s=0.0))
    monitor.record_many(np.full(8, 0.5))
    assert rt.maybe_decide() in (Action.HOLD, Action.STEP_PRECISE)
    rt.notify_capacity(CapacityEvent(elastic.REVOKE, 0, count=2))
    assert rt.capacity_pressure
    monitor.record_many(np.full(8, 0.5))
    act = rt.maybe_decide()
    assert act == Action.SET_MOST_APPROX and rt.active_variant == 1
    assert rt.history[-1]["violated"] and not rt.history[-1]["slack"]
    assert rt.history[-1]["capacity"] == 1
    rt.notify_capacity(CapacityEvent(elastic.RESTORE, 0))
    assert not rt.capacity_pressure
    monitor.record_many(np.full(8, 0.5))
    rt.maybe_decide()
    assert rt.active_variant == 0
    assert [e["kind"] for e in rt.capacity_log] == [elastic.REVOKE,
                                                    elastic.RESTORE]


def test_runtime_inject_fans_out_to_tenants():
    from repro_torch.approx.knobs import PRECISE
    from repro_torch.core.monitor import LatencyMonitor
    from repro_torch.core.runtime import PliantRuntime
    from repro_torch.core.tenant import TrainTenant
    from repro_torch.core.variants import Variant, VariantTable
    table = VariantTable([Variant(PRECISE, 1.0, 0.0)])
    seen = []
    t = TrainTenant(table, name="train", elastic_fn=seen.append)
    rt = PliantRuntime(monitor=LatencyMonitor(1.0), tenants=[t])
    ev = CapacityEvent(elastic.REVOKE, 3, count=1)
    rt.inject(ev)
    assert seen == [ev] and rt.capacity_pressure


def test_runtime_inject_rehomes_the_serve_tenant():
    """Through ``PliantRuntime.inject`` the ``ServeTenant`` routes the
    event to its engine without a second pressure count; the engine
    re-homes at its next step."""
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.monitor import LatencyMonitor
    from repro_torch.core.runtime import PliantRuntime
    from repro_torch.core.tenant import ServeTenant
    from repro_torch.launch.serve import serving_table
    table = serving_table(model()[0], slots=4, max_len=32,
                          page_occupancy=0.5)
    eng = port_engine(mesh=make_mesh((4, 2), ("data", "model"), "cpu"),
                      table=table, **CHAOS)
    tenant = ServeTenant(engine=eng)
    # no decision falls inside the run: the precise rung serves throughout
    rt = PliantRuntime(monitor=LatencyMonitor(1.0), tenants=[tenant],
                       cfg=ControllerConfig(decision_interval_s=1e9))
    eng.attach_runtime(rt, tenant)
    rt.inject(CapacityEvent(elastic.REVOKE, 0, count=2))
    assert rt.capacity_pressure and len(rt.capacity_log) == 1
    assert eng.stats["capacity_events"] == 1
    r = t_engine.Request(0, prompt=[3, 1, 4], max_new=4)
    _serve(eng, [r])
    assert eng.stats["rehomes"] == 1
    assert eng.mesh.shape == {"data": 2, "model": 2}
    assert eng.pool.spec.n_shards == 2 and eng.sharded_kernel
    assert r.out == jax_streams("single")[((3, 1, 4), 12)][:4]
    eng.pool.assert_consistent()


# --------------------------------------------------- checkpoint safety --

def test_restore_latest_skips_corrupt_checkpoints(tmp_path, capsys):
    from repro_torch.ckpt import checkpoint as ckpt
    tree = {"w": np.arange(6.0).reshape(2, 3), "s": np.float32(3.0)}
    ckpt.save(tmp_path / "step_10", tree, 10)
    ckpt.save(tmp_path / "step_20",
              {"w": tree["w"] + 1, "s": np.float32(4.0)}, 20)
    ckpt.save(tmp_path / "step_30",
              {"w": tree["w"] + 2, "s": np.float32(5.0)}, 30)
    shard = tmp_path / "step_30" / "shard0.npz"
    shard.write_bytes(shard.read_bytes()[: 40])
    (tmp_path / "step_20" / "manifest.json").write_text("{not json")
    stale = tmp_path / ".ckpt_tmp_dead"
    stale.mkdir()
    (stale / "junk").write_text("x")
    mgr = ckpt.CheckpointManager(tmp_path)
    assert not stale.exists()
    restored, step = mgr.restore_latest(tree)
    assert step == 10
    assert np.allclose(np.asarray(restored["w"]), tree["w"])
    assert len(mgr.skipped) == 2
    assert "step_30" in mgr.skipped[0] and "step_20" in mgr.skipped[1]
    err = capsys.readouterr().err
    assert err.count("WARNING: skipping corrupt/partial checkpoint") == 2
    (tmp_path / "step_10" / "shard0.npz").write_bytes(b"\x00" * 10)
    mgr2 = ckpt.CheckpointManager(tmp_path)
    restored, step = mgr2.restore_latest(tree)
    assert restored is None and step is None and len(mgr2.skipped) == 3


# --------------------------------------------- mesh 4x2 chaos parity  --

def chaos_run(script, **kw):
    """The JAX test's driver loop on the port: mesh 4x2, 4 slots, 8
    prompts of 7 tokens, 6 new each, the injector polled each step."""
    eng = port_engine(mesh=make_mesh((4, 2), ("data", "model"), "cpu"),
                      **CHAOS, **kw)
    reqs = [t_engine.Request(i, prompt=list(p), max_new=6)
            for i, p in enumerate(chaos_prompts(eng.cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    inj = FaultInjector.parse(script) if script else None
    steps = 0
    while not eng.idle and steps < 2000:
        if inj is not None:
            for ev in inj.due(steps):
                eng.inject(ev)
        eng.step()
        steps += 1
    assert eng.idle, "drained"
    return eng, reqs


def check_chaos_log(eng):
    """The JAX test's assertions on the re-home log."""
    rehomes = [e for e in eng.elastic_log if "mesh_shape" in e]
    assert len(rehomes) == 2, eng.elastic_log
    shrink, grow = rehomes
    assert shrink["kind"] == "revoke" and shrink["revoked"] == [6, 7]
    assert shrink["mesh_shape"] == {"data": 2, "model": 2}, shrink
    assert shrink["n_shards"] == (4, 2) and grow["n_shards"] == (2, 4)
    assert shrink["pages_migrated"] > 0
    assert shrink["recovery_steps"] is not None \
        and shrink["recovery_steps"] >= 1
    assert shrink["cutover_s"] >= 0 and shrink["recovery_s"] >= 0
    assert grow["kind"] == "restore" and grow["revoked"] == []
    assert grow["mesh_shape"] == {"data": 4, "model": 2}, grow
    notice = [e for e in eng.elastic_log if e.get("kind") == "revoke_notice"]
    assert notice and notice[0]["deadline_step"] == notice[0]["step"] + 2
    assert eng.stats["rehomes"] == 2 and eng.stats["capacity_events"] == 2
    eng.pool.assert_consistent()


def test_revoke_2_of_8_mid_decode_token_parity():
    """The headline guarantee: the mesh 4x2 engine that loses 2 positions
    mid-decode (with a grace deadline) and gets them back completes every
    request with the JAX single-device unfaulted engine's tokens, through
    one paged_attention call a shard and never the gather path."""
    attn_mod.DISPATCH_COUNTS.clear()
    eng, got = chaos_run(CHAOS_SCRIPT)
    counts = dict(attn_mod.DISPATCH_COUNTS)
    want = jax_streams("chaos")
    assert all(r.done for r in got), [r.uid for r in got if not r.done]
    assert not eng.rejected, "zero dropped requests"
    assert [r.out for r in got] == [want[(tuple(r.prompt), 6)]
                                    for r in got], "token parity"
    check_chaos_log(eng)
    assert counts.get("kernel_sharded", 0) > 0 and \
        counts.get("gather_mesh", 0) == 0, counts
    assert eng.sharded_kernel and eng.pool.spec.n_shards == 4


def test_serve_cli_chaos(capsys):
    """``--chaos`` through ``launch/serve.main`` on the CPU: the dispatch
    banner names the sharded decode, both capacity events land, the
    elastic summary line reports two re-homes and nothing rejected."""
    from repro_torch.launch import serve
    res = serve.main(["--device", "cpu", "--arch", ARCH, "--paged",
                      "--mesh", "4x2", "--slots", "4", "--requests", "8",
                      "--max-new", "6", "--max-len", "32", "--page-size",
                      "4", "--prefill-chunk", "3", "--prompt-len", "7",
                      "--chaos", CHAOS_SCRIPT])
    out = capsys.readouterr().out
    assert "dispatch: paged decode: paged_attention's plain PyTorch " \
        "version, one launch per shard over 'data' (4 slot-affinity " \
        "shards" in out
    assert "chaos: 2 scripted capacity events" in out
    assert "chaos@4: revoke count=2" in out and "chaos@9: restore" in out
    assert "elastic: events=2 rehomes=2 collective_retries=0" in out
    assert "rejected=0" in out
    assert all(r.done for r in res["requests"])
    check_chaos_log(res["engine"])
