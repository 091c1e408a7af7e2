"""Port parity for serving the vlm and audio families: SMOKE
llama-3.2-vision-90b (2 self layers in 2 groups, 2 gated cross layers,
8 image tokens; gates opened) and SMOKE whisper-base (2 encoder + 2
decoder layers, 16 frames), at the serve example's settings (bisect,
SATA decode on, 8-token blocks, exact re-plan every step), fp32, the
reference's weights loaded into the port.

``serve()`` must give EQUAL greedy token streams, steps and fetch-tile
counters (vlm contiguous, the only layout the reference serves it on;
audio paged and contiguous), with each slot's context drawn before the
prompts, as in the reference.  Teacher-forced logits are held to atol
1e-4 (fp32 summation order); the refusals raise the reference's
errors."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.launch import serve as jsv  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models.config import KVCacheConfig as JKV  # noqa: E402
from repro.models.config import SataDecodeConfig as JDec  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.launch import serve as tsv  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.config import KVCacheConfig as TKV  # noqa: E402
from repro_torch.models.config import SataDecodeConfig as TDec  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402

LOGIT_ATOL = 1e-4
VLM, AUDIO = "llama-3.2-vision-90b", "whisper-base"
EXAMPLE = dict(n_requests=6, batch_slots=3, gen_len=24, max_len=64)


def _cfgs(arch, layout="contiguous", **kv):
    out = []
    for smoke, dec, kvc in ((JSMOKE, JDec, JKV), (TSMOKE, TDec, TKV)):
        base = smoke[arch]
        out.append(dataclasses.replace(
            base, topk_impl="bisect",
            sata=dataclasses.replace(base.sata, decode=dec(
                mode="on", block=8, replan=1)),
            kv=kvc(layout=layout, **kv)))
    return out


_WEIGHTS = {}


def _weights(arch):
    """The reference's seed-0 parameters (vlm's gates opened, so the
    image context reaches the logits) and the port's model built from
    them, once per architecture."""
    if arch not in _WEIGHTS:
        jc, tc = _cfgs(arch)
        params = jmdl.init_params(jax.random.PRNGKey(0), jc)
        if arch == VLM:
            cl = params["cross_layers"]
            params = {**params, "cross_layers": {
                **cl, "gate": jnp.ones_like(cl["gate"]),
                "gate_mlp": jnp.full_like(cl["gate_mlp"], 0.5)}}
        _WEIGHTS[arch] = (params, params_from_jax(
            jax.tree.map(np.asarray, params), tc, device="cpu"))
    return _WEIGHTS[arch]


RUNS = {  # name: (arch, layout, kv overrides, options)
    "vlm_contiguous": (VLM, "contiguous", {}, {}),
    "audio_paged": (AUDIO, "paged", {}, {}),
    "audio_contiguous": (AUDIO, "contiguous", {}, {}),
    # 10 usable pages for 3 slots that each grow to 5: stalls, then
    # preemption — requeue, since audio has no host swap in either package
    "audio_pool_pressure": (AUDIO, "paged", {"pool_pages": 11},
                            {"gen_len": 40}),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_serve_matches_reference(name):
    """Equal greedy streams, steps and fetch counters; on the paged
    layout equal page occupancy and preemption counters."""
    arch, layout, kv, extra = RUNS[name]
    params, model = _weights(arch)
    jc, tc = _cfgs(arch, layout, **kv)
    opts = {**EXAMPLE, **extra}
    want = jsv.serve(arch, smoke=True, cfg=jc, params=params,
                     options=jsv.ServeOptions(**opts))
    got = tsv.serve(arch, smoke=True, cfg=tc, model=model,
                    options=tsv.ServeOptions(**opts), device="cpu")
    assert got["outputs"] == want["outputs"]
    assert all(len(v) == opts["gen_len"] for v in got["outputs"].values())
    assert got["steps"] == want["steps"]
    for k in ("kv_fetch_tiles_plan", "kv_fetch_tiles_dense",
              "plan_fetch_bytes", "replans"):
        assert got["decode_fetch"][k] == want["decode_fetch"][k], k
    if layout == "paged":
        occ, wocc = got["page_occupancy"], want["page_occupancy"]
        for k in ("pages_in_use_peak", "stalled_steps", "preemptions",
                  "deferred_claims", "host_swaps", "requeue_preemptions",
                  "requeue_tokens_discarded", "hbm_reserved_bytes"):
            assert occ[k] == wocc[k], k
    if name == "audio_pool_pressure":
        occ = got["page_occupancy"]
        assert occ["requeue_preemptions"] > 0 and occ["host_swaps"] == 0


def test_context_is_drawn_before_the_prompts(monkeypatch):
    """``serve()`` fills each slot's context from the seed's first draw
    (batch_slots, n_image_tokens, d_model), before the prompts."""
    params, model = _weights(VLM)
    jc, tc = _cfgs(VLM)
    seen = []
    fill = tdec.prefill_context

    def spy(m, cfg, cache, batch):
        seen.append({k: v.clone() for k, v in batch.items()})
        return fill(m, cfg, cache, batch)

    monkeypatch.setattr(tdec, "prefill_context", spy)
    opts = dict(EXAMPLE, n_requests=2, gen_len=2)
    tsv.serve(VLM, smoke=True, cfg=tc, model=model, seed=3,
              options=tsv.ServeOptions(**opts), device="cpu")
    rng = np.random.default_rng(3)
    want = rng.standard_normal((3, tc.n_image_tokens, tc.d_model))
    assert len(seen) == 1 and sorted(seen[0]) == ["image_embeds"]
    np.testing.assert_array_equal(seen[0]["image_embeds"].numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_teacher_forced_logits_and_plan_state_match(arch):
    """``prefill_context`` → 6 ``serve_step``s at per-slot positions,
    the port fed the reference's greedy tokens: cross K/V and logits
    within 1e-4 at every step; then the slot functions over the flat
    self-attention stack equal the reference's (vlm: its batch axis 2 of
    the nested (n_cross, per_group) stack) — ``capture_plan_state``,
    ``reset_slot`` and ``release_slot`` — and leave ``cross_kv``
    alone."""
    params, model = _weights(arch)
    jc, tc = _cfgs(arch)
    b, max_len = 3, 64
    key, n_ctx = (("image_embeds", jc.n_image_tokens) if arch == VLM
                  else ("audio_embeds", jc.encoder_len))
    ctx = np.random.default_rng(4).standard_normal(
        (b, n_ctx, jc.d_model)).astype(np.float32)
    jcache = jdec.prefill_context(params, jc, jdec.init_cache(jc, b, max_len),
                                  {key: jnp.asarray(ctx)})
    tcache = tdec.prefill_context(model, tc, tdec.init_cache(
        tc, b, max_len, device="cpu"), {key: torch.from_numpy(ctx)})
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache["cross_kv"][n].numpy(),
                                   np.asarray(jcache["cross_kv"][n]),
                                   atol=LOGIT_ATOL, rtol=0)
    tok = np.array([[5], [17], [200]], np.int32)
    pos = np.array([0, 3, 9], np.int32)
    for _ in range(6):
        jlg, jcache = jdec.serve_step(params, jc, jcache, jnp.asarray(tok),
                                      jnp.asarray(pos))
        tlg, tcache = tdec.serve_step(model, tc, tcache,
                                      torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg),
                                   atol=LOGIT_ATOL, rtol=0)
        tok = np.argmax(np.asarray(jlg)[:, 0], axis=-1)[:, None].astype(
            np.int32)
        pos = pos + 1
    cross_before = tcache["cross_kv"]["k"].clone()
    axis = 2 if arch == VLM else 1

    def flat(a):
        a = np.asarray(a)
        return a.reshape((-1,) + a.shape[2:]) if arch == VLM else a

    for slot in (1, 2):
        want = jdec.capture_plan_state(jc, jcache, slot)["kv"]
        got = tdec.capture_plan_state(tc, tcache, slot)["kv"]
        assert sorted(got) == sorted(want)
        for f in ("kv_indices", "kv_counts", "step", "replans"):
            np.testing.assert_array_equal(got[f], flat(want[f]), err_msg=f)
    jcache = jdec.release_slot(jc, jdec.reset_slot(jc, jcache, 1), 2)
    tdec.release_slot(tc, tdec.reset_slot(tc, tcache, 1), 2)
    for f, t in tcache["kv"]["plan"].items():
        a = np.asarray(jcache["kv"]["plan"][f])
        assert a.shape[axis] == b
        if t.dtype.is_floating_point:
            np.testing.assert_allclose(t.numpy(), flat(a), atol=LOGIT_ATOL,
                                       rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(t.numpy(), flat(a), err_msg=f)
    assert torch.equal(tcache["cross_kv"]["k"], cross_before)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_prompt_longer_than_one_token_is_refused(arch):
    """vlm and audio have no prompt prefill in either package."""
    _, model = _weights(arch)
    jc, tc = _cfgs(arch)
    opts = dict(EXAMPLE, prompt_len=4)
    with pytest.raises(NotImplementedError) as want:
        jsv.serve(arch, smoke=True, cfg=jc, params=_weights(arch)[0],
                  options=jsv.ServeOptions(**opts))
    with pytest.raises(NotImplementedError) as got:
        tsv.serve(arch, smoke=True, cfg=tc, model=model,
                  options=tsv.ServeOptions(**opts), device="cpu")
    assert str(got.value) == str(want.value)
    assert "prompt_len > 1" in str(got.value)
    with pytest.raises(NotImplementedError, match="prefill_prompt covers"):
        tdec.prefill_prompt(model, tc, torch.zeros((1, 4), dtype=torch.int32),
                            64)


def test_paged_vlm_is_refused_as_in_the_reference():
    jc, tc = _cfgs(VLM, "paged")
    with pytest.raises(NotImplementedError) as want:
        jdec.init_cache(jc, 2, 64)
    with pytest.raises(NotImplementedError) as got:
        tdec.init_cache(tc, 2, 64, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="vlm family"):
        tsv.serve(VLM, smoke=True, cfg=tc, model=_weights(VLM)[1],
                  options=tsv.ServeOptions(**EXAMPLE), device="cpu")
