"""Port parity for serving the moe family and the rest of the dense
family: SMOKE qwen3-moe-235b-a22b with 32 query heads over 2 KV heads
(G = 16, the full config's grouping; head_dim 16, 4 experts, top-2,
group 16) and SMOKE olmo-1b (the non-parametric norm), both at the
serve example's settings (bisect, SATA decode on, 8-token blocks, exact
re-plan every step), fp32, the reference's weights loaded into the port.

``serve()`` must give EQUAL greedy token streams and equal fetch-tile
counters on both layouts; teacher-forced logits are held to atol 1e-4
(fp32 summation order over 4 layers).  A moe token's output depends on
the other tokens of its group, so a prefix-cache hit's prefill is the
reference's continuation prefill over the tail alone: the port must
equal that, not a miss."""
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
MOE, OLMO = "qwen3-moe-235b-a22b", "olmo-1b"
EXAMPLE = dict(n_requests=6, batch_slots=3, gen_len=24, max_len=64)


def _cfgs(arch, layout="contiguous", **kv):
    out = []
    for smoke, dec, kvc in ((JSMOKE, JDec, JKV), (TSMOKE, TDec, TKV)):
        base = smoke[arch]
        if arch == MOE:
            base = dataclasses.replace(base, n_heads=32, n_kv_heads=2)
        out.append(dataclasses.replace(
            base, topk_impl="bisect",
            sata=dataclasses.replace(base.sata, decode=dec(
                mode="on", block=8, replan=1)),
            kv=kvc(layout=layout, **kv)))
    return out


_WEIGHTS = {}


def _weights(arch):
    """The reference's seed-0 parameters and the port's model built
    from them, once per architecture."""
    if arch not in _WEIGHTS:
        jc, tc = _cfgs(arch)
        params = jmdl.init_params(jax.random.PRNGKey(0), jc)
        _WEIGHTS[arch] = (params, params_from_jax(
            jax.tree.map(np.asarray, params), tc, device="cpu"))
    return _WEIGHTS[arch]


def test_moe_smoke_config_groups_sixteen_heads():
    jc, tc = _cfgs(MOE)
    assert tc.n_heads // tc.n_kv_heads == 16 and tc.moe and jc.moe
    assert tc.family == "moe" and tc.n_experts == 4


RUNS = {  # name: (arch, layout, prompt_len, kv overrides, options)
    "moe_contiguous": (MOE, "contiguous", 16, {}, {}),
    "moe_paged": (MOE, "paged", 16, {}, {}),
    "moe_prefix_cache": (MOE, "paged", 32, {"prefix_cache": True},
                         {"shared_prefix_len": 16}),
    "olmo_contiguous": (OLMO, "contiguous", 6, {}, {}),
    "olmo_paged": (OLMO, "paged", 6, {}, {}),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_serve_matches_reference(name):
    """Equal greedy streams, steps and fetch counters; on the paged
    layout equal page occupancy; with the prefix cache on (prompts of 32
    sharing their first 16 tokens: a miss prefills 2 groups, a hit its
    16-token tail as one) equal hit counts."""
    arch, layout, plen, kv, extra = RUNS[name]
    params, model = _weights(arch)
    jc, tc = _cfgs(arch, layout, **kv)
    opts = dict(EXAMPLE, prompt_len=plen, **extra)
    want = jsv.serve(arch, smoke=True, cfg=jc, params=params,
                     options=jsv.ServeOptions(**opts))
    got = tsv.serve(arch, smoke=True, cfg=tc, model=model,
                    options=tsv.ServeOptions(**opts), device="cpu")
    assert got["outputs"] == want["outputs"]
    assert all(len(v) == EXAMPLE["gen_len"] for v in got["outputs"].values())
    assert got["steps"] == want["steps"]
    for k in ("kv_fetch_tiles_plan", "kv_fetch_tiles_dense",
              "plan_fetch_bytes", "replans"):
        assert got["decode_fetch"][k] == want["decode_fetch"][k], k
    if layout == "paged":
        for k in ("pages_in_use_peak", "stalled_steps", "preemptions",
                  "deferred_claims"):
            assert got["page_occupancy"][k] == want["page_occupancy"][k], k
    if kv.get("prefix_cache"):
        for k in ("hits", "prefill_tokens_saved", "cow_copies"):
            assert got["prefix_cache"][k] == want["prefix_cache"][k], k
        assert got["prefix_cache"]["hits"] > 0


def test_moe_teacher_forced_logits_match():
    """prefill_prompt → install_prefill → 6 serve_steps over the page
    pool at G = 16, the port fed the reference's greedy tokens: logits
    within 1e-4 at every step (the decode step's moe group is the 3
    slots, the idle ones included) and identical seeded plans."""
    from repro.core.paging import PageAllocator as JAlloc
    params, model = _weights(MOE)
    jc, tc = _cfgs(MOE, "paged")
    b, max_len, sp, slot = 3, 64, 16, 2
    prompt = np.random.default_rng(3).integers(0, 256, (1, sp)).astype(
        np.int32)
    jl0, jst = jdec.prefill_prompt(params, jc, jnp.asarray(prompt), max_len)
    tl0, tst = tdec.prefill_prompt(model, tc, torch.from_numpy(prompt),
                                   max_len)
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), atol=LOGIT_ATOL,
                               rtol=0)
    for name in ("kv_indices", "kv_counts", "step"):
        np.testing.assert_array_equal(tst["plan"][name].numpy(),
                                      np.asarray(jst["plan"][name]))
    jcache = jdec.init_cache(jc, b, max_len)
    tcache = tdec.init_cache(tc, b, max_len, device="cpu")
    alloc = JAlloc(int(jcache["kv"]["k_pages"].shape[1]), b, 8, 8,
                   audit=False)
    assert alloc.ensure(slot, max_len - 1)
    jcache = jdec.set_page_table(jc, jcache, alloc.table)
    tdec.set_page_table(tc, tcache, alloc.table)
    phys = alloc.table[slot, :2]
    jcache = jdec.install_prefill(jc, jcache, slot, jst, phys)
    tdec.install_prefill(tc, tcache, slot, tst, phys)
    tok = np.zeros((b, 1), np.int32)
    pos = np.zeros(b, np.int32)
    tok[slot, 0] = int(np.argmax(np.asarray(jl0[0])))
    pos[slot] = sp
    for step in range(6):
        jlg, jcache = jdec.serve_step(params, jc, jcache, jnp.asarray(tok),
                                      jnp.asarray(pos))
        tlg, _ = tdec.serve_step(model, tc, tcache, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg),
                                   atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
        tok[slot, 0] = int(np.argmax(np.asarray(jlg[slot, 0])))
        pos[slot] += 1


def test_moe_hit_prefill_is_the_reference_continuation():
    """A prefix-cache hit's moe prefill: the 8-token tail after a
    24-token match runs the FFN over the tail alone, one group of 8, as
    the reference's continuation prefill does (the port computes from
    the 256-row block holding the match, behind 24 pad rows the FFN must
    not see).  Its logits, K/V and seeded plan equal the reference's;
    the miss over the whole prompt routes the tail's tokens in a group
    of 16 with 8 prompt tokens before them and gives other logits, in
    both packages.  (The miss itself is not compared here: at top-k 4
    one attention row of its prefix ties within fp32 summation order and
    selects another key on each side, which moves its logits by ~4e-3;
    with top-k over every key the two agree to 2e-6.  The serve tests
    hold the misses' token streams equal.)"""
    params, model = _weights(MOE)
    jc, tc = _cfgs(MOE)
    max_len, m = 64, 24
    prompt = np.random.default_rng(4).integers(0, 256, (1, 32)).astype(
        np.int32)
    _, jfull = jdec.prefill_prompt(params, jc, jnp.asarray(prompt), max_len)
    jpre = {n: jnp.asarray(jfull[n])[:, :, :m] for n in ("k", "v")}
    jl, jst = jdec.prefill_prompt(params, jc, jnp.asarray(prompt[:, m:]),
                                  max_len, prefix_kv=jpre)
    tpre = {n: torch.from_numpy(np.array(a)) for n, a in jpre.items()}
    tl_, tst = tdec.prefill_prompt(model, tc, torch.from_numpy(prompt[:, m:]),
                                   max_len, prefix_kv=tpre)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(tst[n].numpy(), np.asarray(jst[n]),
                                   atol=LOGIT_ATOL, rtol=0)
    for name in ("kv_indices", "kv_counts", "step"):
        np.testing.assert_array_equal(tst["plan"][name].numpy(),
                                      np.asarray(jst["plan"][name]))
    jmiss, _ = jdec.prefill_prompt(params, jc, jnp.asarray(prompt), max_len)
    tmiss, _ = tdec.prefill_prompt(model, tc, torch.from_numpy(prompt),
                                   max_len)
    assert not np.allclose(np.asarray(jmiss), np.asarray(jl), atol=1e-3)
    assert not np.allclose(tmiss.numpy(), tl_.numpy(), atol=1e-3)


def test_moe_prompt_off_the_group_raises_like_the_reference():
    """A 20-token moe prompt over groups of 16 fails in the reference's
    moe reshape; the port's prefill raises the same error."""
    params, model = _weights(MOE)
    jc, tc = _cfgs(MOE)
    prompt = np.zeros((1, 20), np.int32)
    with pytest.raises(TypeError) as jerr:
        jdec.prefill_prompt(params, jc, jnp.asarray(prompt), 64)
    with pytest.raises(TypeError) as terr:
        tdec.prefill_prompt(model, tc, torch.from_numpy(prompt), 64)
    assert str(terr.value) == str(jerr.value)


def test_moe_host_swap_and_crash_restore_match_reference():
    """The moe family through the fault path, as the reference serves it
    (``launch/serve.py``'s dense/moe gate): a 12-page pool squeezed by 3
    pages at step 2 and restored at 14 (host-swap preemptions), and a
    crash at step 20 (every live slot swapped to host, the device cache
    rebuilt, each request restored).  Streams and every swap and crash
    counter equal the reference's."""
    from repro.launch.faults import FaultPlan as JFaultPlan
    from repro_torch.launch.faults import FaultPlan as TFaultPlan
    params, model = _weights(MOE)
    jc, tc = _cfgs(MOE, "paged", pool_pages=12)
    opts = dict(EXAMPLE, prompt_len=6)

    def plan(fp):
        return fp.pool_squeeze(2, 3).pool_restore(14).crash_step(20)

    want = jsv.serve(MOE, smoke=True, cfg=jc, params=params,
                     options=jsv.ServeOptions(**opts),
                     faults=plan(JFaultPlan()))
    got = tsv.serve(MOE, smoke=True, cfg=tc, model=model,
                    options=tsv.ServeOptions(**opts), device="cpu",
                    faults=plan(TFaultPlan()))
    assert got["outputs"] == want["outputs"]
    assert got["steps"] == want["steps"]
    occ, wocc = got["page_occupancy"], want["page_occupancy"]
    for k in ("preemptions", "host_swaps", "swap_restores", "crashes",
              "requeue_preemptions", "tokens_salvaged",
              "swap_cold_replans", "host_swap_bytes_peak",
              "deferred_claims", "stalled_steps"):
        assert occ[k] == wocc[k], k
    assert occ["host_swaps"] > 0 and occ["crashes"] == 1
    for k in ("kv_fetch_tiles_plan", "kv_fetch_tiles_dense", "replans"):
        assert got["decode_fetch"][k] == want["decode_fetch"][k], k


def test_a_bisection_midpoint_lies_within_a_summation_order_of_a_bf16_edge(
        monkeypatch):
    """Why the fault run above needs one intra-op thread (ROADMAP queue
    C8, closed).  The bisection counts keys with ``bf16(score) >=
    bf16(mid)``, so a midpoint near the edge where bf16 rounds to the
    next value decides on bits that the fp32 sums' order sets.  At one
    thread, request 0's dense top-k prefill has, in its 81st counting
    pass, a row whose midpoint (-0.35644645) lies within 2e-6 of such an
    edge (-0.35644531), and moving it across the edge changes the row's
    key count.  Another summation order moves the scores, and with them
    the midpoints, by about that much: on an AVX-512 host, 8 threads
    split the q projection's sums (6×64 @ 64×512) otherwise, 7.2e-7
    off, that midpoint became -0.35644513, across the edge, the key
    count flipped, the bisection ended at another threshold and
    requests 0, 2 and 5 streamed other tokens.  The port computes what
    the reference does; one thread (``tests/torch_threads.py``) makes
    its sums the same whatever the host's core count."""
    from repro_torch.core import selection as tsel
    _, model = _weights(MOE)
    _, tc = _cfgs(MOE, "paged", pool_pages=12)
    prompts = np.random.default_rng(0).integers(0, tc.vocab_size, (6, 6))
    real = tsel.bisect_select
    calls = []

    def rec(scores, thr):
        calls.append((scores, thr.clone()))
        return real(scores, thr)

    monkeypatch.setattr(tsel, "bisect_select", rec)
    tdec.prefill_prompt(model, tc, torch.from_numpy(prompts[:1]),
                        EXAMPLE["max_len"])
    scores, mid = calls[80]
    b = mid.to(torch.bfloat16)
    bits = b.view(torch.int16)
    a, c = ((bits + 1).view(torch.bfloat16).float(),
            (bits - 1).view(torch.bfloat16).float())
    nb = torch.where(mid > b.float(), torch.maximum(a, c),
                     torch.minimum(a, c))      # the next bf16 past the edge
    dist = (mid - (b.float() + nb) / 2).abs()[..., 0]
    crossed = real(scores, nb).sum(-1) != real(scores, mid).sum(-1)
    assert crossed.any()
    assert float(dist[crossed].min()) < 2e-6, dist[crossed]
