"""The port's colocation harness (``repro_torch.launch.colocate``) against
the JAX package's (``repro.launch.colocate``), on the CPU.

Two pairings at smoke size run through both harnesses with the same
weights (``repro.models.api.init`` at ``--seed`` and ``--seed + 1``,
carried over by ``repro_torch.convert``), the CI smoke's serving sizes,
all requests at t = 0 and a QoS target no step can miss, so neither
arbiter acts and the run does not depend on timing. Then the loops take
the same turns: greedy streams equal token for token, the same number of
train steps with none skipped, and each step's loss within 1e-5 relative
(fp32 sums in other orders over at most a few dozen AdamW steps). The JAX
harness's requests and train losses are read through wrappers installed
here; nothing of the JAX package changes.

A swap the arbiter asks of the serve tenant while an admission is in
flight is deferred to the step the admission completes, in both engines
alike.

The CI smoke (the JAX package's CI job "Colocate harness smoke") runs on
the port with both arbiters. Its 20 ms target is the JAX CPU step's
"impossible" target; the port's CPU decode steps of the smoke model take a
few ms, so the port's runs ask for 1 ms, impossible for them, and must
act."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jax_configs
from repro.core import controller as jax_controller
from repro.core import monitor as jax_monitor
from repro.core import runtime as jax_runtime
from repro.core import tenant as jax_tenant
from repro.launch import colocate as jax_colocate
from repro.launch.serve import serving_table as jax_serving_table
from repro.models import api as jax_api
from repro.serve import engine as jax_engine
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import controller, monitor, runtime, tenant
from repro_torch.launch import colocate
from repro_torch.launch.serve import serving_table
from repro_torch.serve import engine as t_engine

CI = ["--requests", "6", "--slots", "2", "--max-new", "4", "--max-len",
      "32", "--prompt-len", "6"]
PAIRINGS = [("phi4-mini-3.8b-smoke", "mamba2-780m-smoke"),   # the card's
            ("gemma2-27b-smoke", "phi4-mini-3.8b-smoke")]    # JAX defaults
LOSS_REL = 1e-5


def _jax_run(monkeypatch, argv):
    """The JAX harness on ``argv``, with the requests its engine receives
    and every train step's loss recorded."""
    reqs, losses = [], []
    submit = jax_engine.ServeEngine.submit

    def record_submit(self, req):
        reqs.append(req)
        return submit(self, req)

    def record_steps(cfg, table, opt_cfg, **kw):
        jax_colocate_build(cfg, table, opt_cfg, **kw)
        for i, fn in list(table.executables.items()):
            def step(params, opt, batch, fn=fn):
                out = fn(params, opt, batch)
                losses.append(float(out[2]["loss"]))
                return out
            table.executables[i] = step

    jax_colocate_build = jax_colocate.build_variant_steps
    monkeypatch.setattr(jax_engine.ServeEngine, "submit", record_submit)
    monkeypatch.setattr(jax_colocate, "build_variant_steps", record_steps)
    summary = jax_colocate.main(argv)
    return summary, reqs, losses


def _converted(arch, seed):
    jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
    jp = jax_api.init(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)


@pytest.mark.parametrize("serve_arch,train_arch", PAIRINGS,
                         ids=["phi4-serve+mamba2-train",
                              "gemma2-serve+phi4-train"])
def test_pairing_matches_jax_harness(monkeypatch, serve_arch, train_arch):
    argv = ["--serve-arch", serve_arch, "--train-arch", train_arch,
            "--rate", "0", "--qos-target", "1000"] + CI
    want, jreqs, jlosses = _jax_run(monkeypatch, argv)
    got = colocate.main(argv + ["--device", "cpu"],
                        serve_params=_converted(serve_arch, 0),
                        train_params=_converted(train_arch, 1))
    run = got.pop("run")
    assert set(got) == set(want)
    for s in (got, want):
        assert s["actions"] == 0 and s["requests_done"] == 6, s
        assert s["train_skipped"] == 0, s
    assert [r.uid for r in jreqs] == list(range(6))
    assert [r.out for r in run["requests"]] == \
        [list(map(int, r.out)) for r in jreqs]
    assert got["tokens"] == want["tokens"] == 24
    assert got["train_steps"] == want["train_steps"] == len(jlosses) > 0
    np.testing.assert_allclose(run["losses"], jlosses, rtol=LOSS_REL,
                               atol=0)
    np.testing.assert_allclose(got["train_final_loss"],
                               want["train_final_loss"], rtol=LOSS_REL)
    for k in ("serve_variant", "train_variant", "serve_reclaimed_pages",
              "train_yielded_quanta", "victims", "swaps",
              "train_mean_quality_loss"):
        assert got[k] == want[k], (k, got[k], want[k])


@pytest.mark.parametrize("arbiter", ["interference", "round_robin"])
def test_ci_smoke_acts(tmp_path, arbiter):
    """The CI smoke's command and its three assertions, on the port, with
    the default pairing (gemma2-27b-smoke serving, phi4-mini-3.8b-smoke
    training) and the seeded weights; ``--json`` holds the summary."""
    out = tmp_path / "colocate.json"
    s = colocate.main(CI + ["--qos-target", "0.001", "--decision-interval",
                            "0.02", "--arbiter", arbiter, "--json",
                            str(out), "--device", "cpu"])
    written = json.loads(out.read_text())
    assert set(written) == set(s) - {"run"}
    assert written["requests_done"] == 6, written
    assert written["train_steps"] > 0, written
    assert written["actions"] > 0, written
    assert written["arbiter"] == arbiter


def test_serve_tenant_swap_defers_mid_admission():
    """The serve tenant bound through ``attach_runtime`` (as the harness
    binds it): ``set_variant`` asked while a prompt admits one chunk a step
    lands only at the step its admission completes, on both engines; the
    streams after the swap are equal. No decision fires (the interval is
    never reached), so the swap is the test's alone."""
    arch = "phi4-mini-3.8b-smoke"
    jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
    jparams = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, 256, 20)]
    kw = dict(batch_slots=2, max_len=32, page_size=4, prefill_chunk=4,
              max_admission_chunks=1, seed=0)
    sides = {}
    for side, (eng_mod, ten, rt, ctl, mon, table_fn, params, cfg, extra) in {
            "jax": (jax_engine, jax_tenant, jax_runtime, jax_controller,
                    jax_monitor, jax_serving_table, jparams, jcfg,
                    dict(paged=True)),
            "port": (t_engine, tenant, runtime, controller, monitor,
                     serving_table, _converted(arch, 0), tcfg,
                     dict(device="cpu"))}.items():
        eng = eng_mod.ServeEngine(cfg, params=params, table=table_fn(
            cfg, slots=2, max_len=32, page_occupancy=0.5), **kw, **extra)
        serve = ten.ServeTenant(engine=eng, name="serve")
        rtm = rt.PliantRuntime(
            monitor=mon.LatencyMonitor(qos_target_s=1000.0),
            cfg=ctl.ControllerConfig(decision_interval_s=1e9),
            tenants=[serve])
        eng.attach_runtime(rtm, serve)
        req = eng_mod.Request(0, prompt=list(prompt), max_new=6)
        eng.submit(req)
        eng.step()                          # chunk 1 of 5 in flight
        serve.set_variant(2)
        trace = [(eng.active_variant, len(req.out))]
        while not req.done:
            eng.step()
            trace.append((eng.active_variant, len(req.out)))
        sides[side] = (trace, list(map(int, req.out)), list(eng.swaps))
    trace, out, swaps = sides["port"]
    assert sides["port"] == sides["jax"], sides
    # precise while the prompt admits (no token yet), int8+kvq8 from the
    # step whose drain gave the first token on
    first = next(i for i, (_, n) in enumerate(trace) if n > 0)
    assert first == 4, trace
    assert all(v == 0 for v, _ in trace[:first]), trace
    assert all(v == 2 for v, _ in trace[first:]), trace
    assert len(swaps) == 1 and swaps[0][1] == 2, swaps
