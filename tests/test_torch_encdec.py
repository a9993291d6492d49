"""The port's encoder-decoder family (``models/encdec.py``, the blocks'
cross sublayer, ``convert.py``'s encdec tree, ``train/step.py``'s serve
step and prefill) against the JAX package on whisper-large-v3-smoke, on
the CPU: the same fp32 weights (``repro.models.api.init``, converted
through numpy with ``repro_torch.convert``) and the same numpy-seeded
tokens and frames go through both.

Tolerances: fp32 sums taken in other orders. Hidden states, logits and
precise losses within 1e-5 of the largest entry (relative); losses on the
int8 rungs within 1e-4; gradients within 1e-4 of each leaf's largest
entry, and on int8 their zero pattern equal; the decode step against the
full forward at the JAX test's 3e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.approx.knobs import ApproxKnobs as JaxKnobs
from repro.models import api as jax_api
from repro.models import encdec as jax_encdec
from repro.models import lm as jax_lm
from repro.train import step as jax_step
from repro_torch import configs as t_configs
from repro_torch.approx.knobs import ApproxKnobs
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.models import api as t_api
from repro_torch.models import encdec as t_encdec
from repro_torch.models import lm as t_lm
from repro_torch.train import step as t_step

ARCH = "whisper-large-v3-smoke"
B, S = 2, 16
VAL_REL, INT8_REL, GRAD_REL = 1e-5, 1e-4, 1e-4
# the explorer's training ladder for whisper (precise, int8, int8 +
# kv_keep_stride 2, int8 + token_drop 0.5), and layer_skip
RUNGS = {"precise": dict(), "int8": dict(matmul_precision="int8"),
         "int8+kvstride2": dict(matmul_precision="int8", kv_keep_stride=2),
         "int8+drop50%": dict(matmul_precision="int8", token_drop=0.5),
         "skip50%": dict(layer_skip=0.5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jax_configs.get_config(ARCH), t_configs.get_config(ARCH)
    jparams = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
    frames = rng.normal(size=(B, tcfg.encoder_seq, tcfg.d_model)
                        ).astype(np.float32)
    return jcfg, tcfg, jparams, np_tree, tokens, frames


def _tparams(tcfg, np_tree):
    return params_from_numpy(np_tree, tcfg)


def _close_rel(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_params_roundtrip_encdec_tree(model):
    """``params_from_numpy`` unstacks ``enc`` into ``n_encoder_layers``
    blocks and ``dec.pos0`` into one block per decoder layer with its
    ``cross`` and ``norm_cross``; ``tree_to_numpy`` restacks them
    exactly, and the port's init has the same leaves and shapes."""
    jcfg, tcfg, _, np_tree, _, _ = model
    tp = _tparams(tcfg, np_tree)
    assert len(tp.enc) == tcfg.n_encoder_layers
    assert len(tp.dec) == tcfg.n_groups
    assert set(dict(tp.dec[0].named_children())) == {
        "attn", "cross", "mlp"}
    back = tree_to_numpy(dict(tp.named_parameters()), tcfg)
    jax.tree.map(np.testing.assert_array_equal, back, np_tree)
    init = t_api.init(tcfg, 0, torch.float32, "cpu")
    shapes = {k: tuple(v.shape) for k, v in _flat(tree_to_numpy(
        dict(init.named_parameters()), tcfg)).items()}
    assert shapes == {k: v.shape for k, v in _flat(np_tree).items()}
    assert sum(p.numel() for p in init.parameters()) == tcfg.param_count()


def _enc(model):
    jcfg, tcfg, jparams, np_tree, tokens, frames = model
    want = jax.jit(lambda p, f: jax_encdec.encode(p, f, jcfg, remat="none"))(
        jparams, jnp.asarray(frames))
    return want


def test_encode_matches_jax(model):
    jcfg, tcfg, jparams, np_tree, _, frames = model
    want = _enc(model)
    got = t_encdec.encode(_tparams(tcfg, np_tree), torch.from_numpy(frames),
                          tcfg, remat="none")
    _close_rel(got.numpy(), want, VAL_REL)


@pytest.mark.parametrize("rung", ["precise", "skip50%"])
def test_decode_hidden_matches_jax(model, rung):
    jcfg, tcfg, jparams, np_tree, tokens, frames = model
    enc = _enc(model)
    want = jax.jit(lambda p, t, e: jax_encdec.decode_hidden(
        p, t, e, jcfg, JaxKnobs(**RUNGS[rung]), remat="none"))(
        jparams, jnp.asarray(tokens[:, :-1]), enc)
    got = t_encdec.decode_hidden(
        _tparams(tcfg, np_tree), torch.from_numpy(tokens[:, :-1]),
        torch.tensor(np.asarray(enc)), tcfg, ApproxKnobs(**RUNGS[rung]),
        remat="full")
    _close_rel(got.detach().numpy(), want, VAL_REL)


@pytest.mark.parametrize("rung", ["precise", "int8", "int8+kvstride2",
                                  "int8+drop50%"])
def test_encdec_loss_and_grads_match_jax(model, rung):
    """``encdec_loss`` and its gradient tree against
    ``jax.value_and_grad`` on each rung of whisper's training ladder
    (``token_drop`` cuts the tokens and the frames alike; aux is 0)."""
    jcfg, tcfg, jparams, np_tree, tokens, frames = model
    batch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}

    def jloss(p):
        return jax_encdec.encdec_loss(p, batch, jcfg, JaxKnobs(**RUNGS[rung]),
                                      remat="none")[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tp = _tparams(tcfg, np_tree).requires_grad_(True)
    named = dict(tp.named_parameters())
    tl, met = t_encdec.encdec_loss(
        tp, {"tokens": torch.from_numpy(tokens),
             "frames": torch.from_numpy(frames)}, tcfg,
        ApproxKnobs(**RUNGS[rung]), remat="full")
    assert float(met["aux"]) == 0.0
    _close_rel(float(tl.detach()), float(jl),
               VAL_REL if rung == "precise" else INT8_REL, "loss")
    grads = torch.autograd.grad(tl, list(named.values()))
    got = _flat(tree_to_numpy(dict(zip(named, grads)), tcfg))
    want = _flat(jax.tree.map(np.asarray, jg))
    assert got.keys() == want.keys()
    for k in want:
        _close_rel(got[k], want[k], GRAD_REL, k)
        if rung != "precise":
            assert np.array_equal(got[k] != 0, want[k] != 0), k


def test_decode_step_matches_jax_and_full_forward(model):
    """``encdec_decode_step`` over S teacher-forced tokens on
    ``init_caches`` rings, the cross K/V recomputed from ``enc_out`` every
    step: each step's logits equal the JAX step's, and the last the full
    forward's (twin of ``test_decode_matches_full_forward[whisper]``, at
    its 3e-3)."""
    jcfg, tcfg, jparams, np_tree, tokens, frames = model
    tp = _tparams(tcfg, np_tree)
    toks = tokens[:, :S]
    enc = _enc(model)
    t_enc = t_encdec.encode(tp, torch.from_numpy(frames), tcfg, remat="none")
    jc = jax_encdec.init_caches(jcfg, B, S, dtype=jnp.float32)
    tc = t_encdec.init_caches(tcfg, B, S, dtype=torch.float32)
    jstep = jax.jit(lambda p, t, pos, c, e: jax_encdec.encdec_decode_step(
        p, t, pos, c, e, jcfg))
    for i in range(S):
        pos = np.full((B,), i, np.int32)
        want, jc = jstep(jparams, jnp.asarray(toks[:, i:i + 1]),
                         jnp.asarray(pos), jc, enc)
        got, tc = t_encdec.encdec_decode_step(
            tp, torch.from_numpy(toks[:, i:i + 1]), torch.from_numpy(pos),
            tc, t_enc, tcfg)
        _close_rel(got.numpy(), want, VAL_REL, f"step {i}")
    h = t_encdec.decode_hidden(tp, torch.from_numpy(toks), t_enc, tcfg,
                               remat="none")
    full = t_lm.logits_fn(tp, h[:, -1], tcfg)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=3e-3,
                               atol=3e-3)


def test_make_serve_step_matches_jax(model):
    """``make_serve_step`` (the encdec branch, with ``enc_out``) on the
    int8 rung, three steps."""
    jcfg, tcfg, jparams, np_tree, tokens, frames = model
    knobs = RUNGS["int8"]
    tp = _tparams(tcfg, np_tree)
    enc = _enc(model)
    jfn = jax.jit(jax_step.make_serve_step(jcfg, JaxKnobs(**knobs)))
    tfn = t_step.make_serve_step(tcfg, ApproxKnobs(**knobs))
    jc = jax_encdec.init_caches(jcfg, B, 8, dtype=jnp.float32)
    tc = t_encdec.init_caches(tcfg, B, 8, dtype=torch.float32)
    for i in range(3):
        pos = np.full((B,), i, np.int32)
        want, jc = jfn(jparams, jnp.asarray(tokens[:, i:i + 1]),
                       jnp.asarray(pos), jc, enc)
        got, tc = tfn(tp, torch.from_numpy(tokens[:, i:i + 1]),
                      torch.from_numpy(pos), tc,
                      torch.tensor(np.asarray(enc)))
        _close_rel(got.numpy(), want, INT8_REL, f"step {i}")


def test_make_prefill_fn_matches_jax(model):
    jcfg, tcfg, jparams, np_tree, tokens, frames = model
    want = jax.jit(jax_step.make_prefill_fn(jcfg, remat="none"))(
        jparams, {"tokens": jnp.asarray(tokens),
                  "frames": jnp.asarray(frames)})
    got = t_step.make_prefill_fn(tcfg, remat="full")(
        _tparams(tcfg, np_tree), {"tokens": torch.from_numpy(tokens),
                                  "frames": torch.from_numpy(frames)})
    assert got.shape == (B, tcfg.vocab_size)
    _close_rel(got.numpy(), want, VAL_REL)


def test_input_specs_and_make_inputs_match_jax():
    """``input_specs`` gives the JAX package's shapes for every cell kind
    of whisper, paligemma and a decoder, and ``make_inputs`` draws a batch
    of them from an explicit generator (the same draws twice)."""
    from repro_torch.configs.base import SHAPES
    from repro.configs.base import SHAPES as JAX_SHAPES
    for arch in ("whisper-large-v3", "paligemma-3b", "gemma3-12b"):
        jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
        for name in SHAPES:
            got = t_api.input_specs(tcfg, SHAPES[name])
            want = jax_api.input_specs(jcfg, JAX_SHAPES[name])
            assert {k: v[0] for k, v in got.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}, (arch, name)
            assert {k: str(v[1]).split(".")[-1] for k, v in got.items()} == \
                {k: str(v.dtype) for k, v in want.items()}, (arch, name)
    tcfg = t_configs.get_config(ARCH)
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig("t", 8, 2, "train")
    a, b = (t_api.make_inputs(tcfg, shape, torch.Generator().manual_seed(3))
            for _ in range(2))
    assert a.keys() == {"tokens", "frames"}
    assert a["frames"].shape == (2, tcfg.encoder_seq, tcfg.d_model)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["tokens"].max()) < tcfg.vocab_size


@pytest.mark.parametrize("arch", ["whisper-large-v3-smoke",
                                  "paligemma-3b-smoke"])
def test_colocate_refuses_encdec_and_vlm_train_tenants(arch):
    """The colocation harness's guard (the JAX harness's): its synthetic
    batch covers token-only families, so an encoder-decoder or a vlm
    train tenant is refused with the JAX package's message."""
    from repro_torch.launch import colocate
    with pytest.raises(AssertionError,
                       match="colocate's synthetic batch covers token-only "
                             "families"):
        colocate.main(["--device", "cpu", "--train-arch", arch,
                       "--requests", "1", "--slots", "1", "--max-len", "16"])
