"""Port parity: cross-attention (the vlm and audio families) against the
JAX reference on the same numpy inputs — ``attention_apply(kv_src=)``,
``precompute_cross_kv``, ``cross_attention_decode`` with and without the
context-length mask, and the padding gate in both packages.

SMOKE widths (d_model 64, 4 heads × 16), fp32.  Tolerance: anything with
a matmul 1e-5 (fp32 summation order over d_model)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402

MM_ATOL = 1e-5       # fp32 matmul summation order
VLM, AUDIO = "llama-3.2-vision-90b", "whisper-base"


def _cfgs(arch=VLM, **kw):
    return [dataclasses.replace(s[arch], **kw) for s in (JSMOKE, TSMOKE)]


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _attn_params(cfg, seed=0):
    """Cross-attention params (qk-norm scales made non-trivial when the
    config has them) as JAX arrays and torch tensors."""
    p = jattn.attention_init(jax.random.PRNGKey(seed), cfg, cross=True)
    if cfg.qk_norm:
        p = {**p, "q_scale": p["q_scale"] * 1.1, "k_scale": p["k_scale"] * 0.9}
    return p, {n: torch.from_numpy(np.array(a)) for n, a in p.items()}


def _close(got, want, atol=MM_ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# (arch, qk_norm, topk_impl): the vlm and audio smoke configs, qk-norm on
# the context keys, and both top-k selections over the context
CASES = [(VLM, False, "auto"), (VLM, True, "bisect"), (AUDIO, False, "sort"),
         (AUDIO, True, "auto")]


@pytest.mark.parametrize("arch,qk_norm,impl", CASES)
def test_project_qkv_from_the_context_matches(arch, qk_norm, impl):
    """q from x, k/v from ``kv_src`` (another length than x)."""
    jc, tc = _cfgs(arch, qk_norm=qk_norm, topk_impl=impl)
    jp, tp = _attn_params(jc)
    x, ctx = _rand(1, 2, 5, 64), _rand(2, 2, 11, 64)
    got = tattn._project_qkv(tp, tc, torch.from_numpy(x),
                             torch.from_numpy(ctx))
    want = jattn._project_qkv(jp, jc, jnp.asarray(x), jnp.asarray(ctx))
    assert got[1].shape == (2, 11, tc.n_kv_heads, tc.hd)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("arch,qk_norm,impl", CASES)
def test_attention_apply_cross_matches(arch, qk_norm, impl):
    """``attention_apply(kv_src=)``: non-causal over the whole context, no
    RoPE on either side, top-k over the context, query-chunked (q_chunk 8
    over 16 rows: two chunks)."""
    jc, tc = _cfgs(arch, qk_norm=qk_norm, topk_impl=impl)
    jp, tp = _attn_params(jc, seed=3)
    x, ctx = _rand(4, 2, 16, 64), _rand(5, 2, 12, 64)
    got = tattn.attention_apply(tp, tc, torch.from_numpy(x),
                                kv_src=torch.from_numpy(ctx))
    want = jattn.attention_apply(jp, jc, jnp.asarray(x),
                                 kv_src=jnp.asarray(ctx))
    _close(got, want)
    # a cross call is not causal by default: the last context key reaches
    # the first query row
    ctx2 = ctx.copy()
    ctx2[:, -1] += 3.0
    moved = tattn.attention_apply(tp, tc, torch.from_numpy(x),
                                  kv_src=torch.from_numpy(ctx2))
    assert (moved[:, 0] - got[:, 0]).abs().max() > 0


@pytest.mark.parametrize("arch,qk_norm", [(VLM, False), (AUDIO, True)])
def test_precompute_cross_kv_matches(arch, qk_norm):
    jc, tc = _cfgs(arch, qk_norm=qk_norm)
    jp, tp = _attn_params(jc, seed=6)
    ctx = _rand(7, 3, 9, 64)
    got = tattn.precompute_cross_kv(tp, tc, torch.from_numpy(ctx))
    want = jattn.precompute_cross_kv(jp, jc, jnp.asarray(ctx))
    assert sorted(got) == sorted(want) == ["k", "v"]
    for n in ("k", "v"):
        assert got[n].shape == (3, 9, tc.n_kv_heads, tc.hd)
        _close(got[n], want[n])


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("arch,qk_norm", [(VLM, False), (AUDIO, True)])
def test_cross_attention_decode_matches(arch, qk_norm, with_valid):
    """One-token cross-attention over precomputed context K/V, with and
    without the per-slot ``valid`` length mask (lengths 3, 9, 1)."""
    jc, tc = _cfgs(arch, qk_norm=qk_norm, topk_k=2)
    jp, tp = _attn_params(jc, seed=8)
    ctx, x = _rand(9, 3, 9, 64), _rand(10, 3, 1, 64)
    jkv = jattn.precompute_cross_kv(jp, jc, jnp.asarray(ctx))
    tkv = tattn.precompute_cross_kv(tp, tc, torch.from_numpy(ctx))
    if with_valid:
        valid = np.arange(9)[None, :] < np.array([3, 9, 1])[:, None]
        jkv = {**jkv, "valid": jnp.asarray(valid)}
        tkv = {**tkv, "valid": torch.from_numpy(valid)}
    got = tattn.cross_attention_decode(tp, tc, torch.from_numpy(x), tkv)
    want = jattn.cross_attention_decode(jp, jc, jnp.asarray(x), jkv)
    assert got.shape == (3, 1, 64)
    _close(got, want)


def test_valid_mask_hides_the_padded_context_bitwise():
    """With ``valid``, what lies past a slot's length cannot reach its
    output: two different paddings give bitwise equal outputs."""
    _, tc = _cfgs(VLM)
    jp, tp = _attn_params(JSMOKE[VLM], seed=11)
    ctx, x = _rand(12, 2, 8, 64), _rand(13, 2, 1, 64)
    valid = torch.from_numpy(np.arange(8)[None, :] < np.array([[5], [2]]))
    outs = []
    for scale in (1.0, -7.0):
        padded = ctx.copy()
        padded[0, 5:] *= scale
        padded[1, 2:] *= scale
        kv = tattn.precompute_cross_kv(tp, tc, torch.from_numpy(padded))
        outs.append(tattn.cross_attention_decode(
            tp, tc, torch.from_numpy(x), {**kv, "valid": valid}))
    assert torch.equal(outs[0], outs[1])


def _open_gates(params):
    """The gated x-attn inits closed (tanh(0) = 0): open it so the context
    reaches the logits, as the reference's own test does."""
    cl = params["cross_layers"]
    return {**params, "cross_layers": {**cl,
                                       "gate": jnp.ones_like(cl["gate"])}}


def test_cross_attention_decode_masks_padded_context():
    """The reference's padding gate, in both packages: two paddings of
    the same image context decode bitwise equal once ``context_lengths``
    is threaded, and differ without it; the port's logits equal the
    reference's within 1e-5 in all four runs."""
    jc, tc = JSMOKE[VLM], TSMOKE[VLM]
    params = _open_gates(jmdl.init_params(jax.random.PRNGKey(0), jc))
    model = params_from_jax(jax.tree.map(np.asarray, params), tc,
                            device="cpu")
    rng = np.random.default_rng(2)
    b, s_ctx, length = 2, jc.n_image_tokens, 5
    real = rng.standard_normal((b, s_ctx, jc.d_model))
    pad_a, pad_b = real.copy(), real.copy()
    pad_a[:, length:] = rng.standard_normal((b, s_ctx - length, jc.d_model))
    pad_b[:, length:] = 5.0 * rng.standard_normal((b, s_ctx - length,
                                                   jc.d_model))
    toks = rng.integers(0, jc.vocab_size, (b, 1)).astype(np.int32)
    lengths = np.full(b, length)

    def run_jax(embeds, with_lengths):
        batch = {"image_embeds": jnp.asarray(embeds, jnp.float32)}
        if with_lengths:
            batch["context_lengths"] = jnp.asarray(lengths)
        cache = jdec.init_cache(jc, batch=b, max_len=8)
        cache = jdec.prefill_context(params, jc, cache, batch)
        lg, _ = jdec.serve_step(params, jc, cache, jnp.asarray(toks),
                                jnp.int32(0))
        return np.asarray(lg)

    def run_port(embeds, with_lengths):
        batch = {"image_embeds": torch.tensor(embeds, dtype=torch.float32)}
        if with_lengths:
            batch["context_lengths"] = torch.from_numpy(lengths)
        cache = tdec.init_cache(tc, batch=b, max_len=8, device="cpu")
        tdec.prefill_context(model, tc, cache, batch)
        assert ("valid" in cache["cross_kv"]) == with_lengths
        lg, _ = tdec.serve_step(model, tc, cache, torch.from_numpy(toks), 0)
        return lg.numpy()

    got = {(e, w): run_port(emb, w) for e, emb in (("a", pad_a),
                                                  ("b", pad_b))
           for w in (True, False)}
    np.testing.assert_array_equal(got["a", True], got["b", True])
    assert np.abs(got["a", False] - got["b", False]).max() > 0
    want = {(e, w): run_jax(emb, w) for e, emb in (("a", pad_a),
                                                  ("b", pad_b))
            for w in (True, False)}
    np.testing.assert_array_equal(want["a", True], want["b", True])
    for key, lg in got.items():
        np.testing.assert_allclose(lg, want[key], atol=MM_ATOL, rtol=0,
                                   err_msg=str(key))
