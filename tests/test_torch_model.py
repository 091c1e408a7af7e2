"""Port parity: layers, one-layer decode attention, and the page
allocator, against the JAX reference on the same numpy inputs
(``SMOKE["qwen3-4b"]`` widths, fp32).

Tolerances: elementwise layers 1e-6 (fp32 transcendental/rounding
differences between XLA and PyTorch); anything with a matmul 1e-5 (fp32
summation order over d_model / d_ff)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.core.paging import PageAllocator as JAlloc  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.config import KVCacheConfig as JKV  # noqa: E402
from repro.models.config import SataDecodeConfig as JDec  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.core.paging import PageAllocator as TAlloc  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.config import KVCacheConfig as TKV  # noqa: E402
from repro_torch.models.config import SataDecodeConfig as TDec  # noqa: E402

ELEM_ATOL = 1e-6     # elementwise fp32 ops
MM_ATOL = 1e-5       # fp32 matmul summation order


def _cfgs(layout="contiguous", replan=1, mode="on"):
    """Same configuration on both sides: qwen3-4b smoke, bisect, SATA
    decode on with 8-token blocks (the serve example's settings)."""
    out = []
    for smoke, dec, kvc in ((JSMOKE, JDec, JKV), (TSMOKE, TDec, TKV)):
        base = smoke["qwen3-4b"]
        out.append(dataclasses.replace(
            base, topk_impl="bisect",
            sata=dataclasses.replace(base.sata, decode=dec(
                mode=mode, block=8, replan=replan)),
            kv=kvc(layout=layout)))
    return out


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_config_copies_read_the_same():
    from repro.configs.archs import ARCHS as JA
    from repro_torch.configs.archs import ARCHS as TA
    assert sorted(JA) == sorted(TA)
    for name in ("qwen3-4b", "phi4-mini-3.8b"):
        for a, b in ((JA[name], TA[name]),
                     (JSMOKE[name], TSMOKE[name])):
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                      "d_ff", "vocab_size", "hd", "qk_norm", "topk_k",
                      "dtype", "rope_theta"):
                assert getattr(a, f) == getattr(b, f), (name, f)
            assert dataclasses.asdict(a.sata) == dataclasses.asdict(b.sata)


def test_norms_and_rope_match():
    jc, tc = _cfgs()
    x = _rand(0, 2, 5, 64)
    scale = 1.0 + 0.1 * _rand(1, 64)
    _close(tl.apply_norm({"scale": torch.from_numpy(scale)}, tc,
                         torch.from_numpy(x)),
           jl.apply_norm({"scale": jnp.asarray(scale)}, jc, jnp.asarray(x)),
           ELEM_ATOL)
    h = _rand(2, 2, 5, 4, 16)
    hs = 1.0 + 0.1 * _rand(3, 16)
    _close(tl.rms_head_norm(torch.from_numpy(h), torch.from_numpy(hs)),
           jl.rms_head_norm(jnp.asarray(h), jnp.asarray(hs)), ELEM_ATOL)
    _close(tl.rope_freqs(16, 10000.0, device="cpu"),
           jl.rope_freqs(16, 10000.0), 0.0)
    pos = np.array([[0, 3, 7, 31, 60]], np.int32).repeat(2, 0)
    _close(tl.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                         10000.0),
           jl.apply_rope(jnp.asarray(h), jnp.asarray(pos), 10000.0),
           ELEM_ATOL)


def test_mlp_embed_unembed_match():
    jc, tc = _cfgs()
    p = {n: _rand(i, *s) / 8 for i, (n, s) in enumerate(
        (("wi", (64, 128)), ("wg", (64, 128)), ("wo", (128, 64))))}
    x = _rand(9, 2, 3, 64)
    _close(tl.mlp_apply({n: torch.from_numpy(a) for n, a in p.items()}, tc,
                        torch.from_numpy(x)),
           jl.mlp_apply({n: jnp.asarray(a) for n, a in p.items()}, jc,
                        jnp.asarray(x)), MM_ATOL)
    emb = {"embedding": _rand(10, 256, 64), "unembed": _rand(11, 64, 256)}
    tok = np.array([[0, 5, 255]], np.int32)
    _close(tl.embed_apply({"embedding": torch.from_numpy(emb["embedding"])},
                          torch.from_numpy(tok)),
           jl.embed_apply({"embedding": jnp.asarray(emb["embedding"])},
                          jnp.asarray(tok)), 0.0)
    got = tl.unembed_apply({n: torch.from_numpy(a) for n, a in emb.items()},
                           tc, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, jl.unembed_apply({n: jnp.asarray(a) for n, a in emb.items()},
                                 jc, jnp.asarray(x)), MM_ATOL)


def _attn_params(cfg):
    p = jattn.attention_init(jax.random.PRNGKey(0), cfg)
    # non-trivial qk-norm scales so the norm's scale path is exercised
    p = {**p, "q_scale": p["q_scale"] * 1.1, "k_scale": p["k_scale"] * 0.9}
    return p, {n: torch.from_numpy(np.array(a)) for n, a in p.items()}


@pytest.mark.parametrize("layout,replan,mode", [
    ("contiguous", 1, "on"), ("paged", 1, "on"), ("contiguous", 3, "on"),
    ("paged", 3, "on"), ("contiguous", 1, "off"), ("paged", 1, "off")])
def test_attention_decode_steps_match(layout, replan, mode):
    """Drive one attention layer's decode for 14 steps on both sides
    (per-slot positions, a slot claimed late) and compare every step's
    output and the plan's integer state.  ``mode="off"`` is the dense
    decode path (no plan)."""
    jc, tc = _cfgs(layout, replan, mode)
    jp, tp = _attn_params(jc)
    b, max_len = 2, 32
    jcache = jattn.init_kv_cache(jc, b, max_len, jnp.float32)
    tcache = tattn.init_kv_cache(tc, b, max_len, torch.float32,
                                 device="cpu")
    if layout == "paged":
        alloc = JAlloc(b * 4 + 1, b, 4, 8, audit=False)
        for i in range(b):
            assert alloc.ensure(i, max_len - 1)
        jcache = {**jcache, "page_table": jnp.asarray(alloc.table)}
        tcache["page_table"].copy_(torch.from_numpy(alloc.table))
    xs = _rand(20, 14, b, 1, 64)
    jstep = jax.jit(lambda p, x, c, pos: jattn.attention_decode(p, jc, x, c,
                                                                pos))
    for t in range(14):
        pos = np.array([t, max(t - 5, 0)], np.int32)    # slot 1 lags
        jy, jcache = jstep(jp, jnp.asarray(xs[t]), jcache, jnp.asarray(pos))
        ty, _ = tattn.attention_decode(tp, tc, torch.from_numpy(xs[t]),
                                       tcache, torch.from_numpy(pos))
        _close(ty, jy, MM_ATOL)
        assert ("plan" in tcache) == (mode == "on") == ("plan" in jcache)
        for name in (() if mode == "off" else
                     ("kv_indices", "kv_counts", "step", "replans")):
            np.testing.assert_array_equal(
                tcache["plan"][name].numpy(),
                np.asarray(jcache["plan"][name]), err_msg=f"{t} {name}")


@pytest.mark.parametrize("impl", ["sort", "bisect"])
def test_topk_threshold_mask_matches(impl):
    s = _rand(40, 2, 3, 5, 24)
    s[..., ::5] = tattn.NEG_INF             # masked entries
    for k in (3, 24):                       # k >= n keeps everything
        want = jattn.topk_threshold_mask(jnp.asarray(s), k, impl=impl)
        got = tattn.topk_threshold_mask(torch.from_numpy(s), k, impl=impl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_page_allocator_core_matches():
    """One claim / append / stall / free sequence through both
    allocators: identical tables, free lists and occupancy."""
    ja = JAlloc(n_pages=7, batch_slots=3, max_pages=4, page=4, audit=True)
    ta = TAlloc(n_pages=7, batch_slots=3, max_pages=4, page=4)
    ops = [("ensure", 0, 0), ("ensure", 1, 5), ("ensure", 0, 7),
           ("ensure", 2, 3), ("ensure", 1, 9), ("ensure", 0, 15),  # stall
           ("free", 1), ("ensure", 0, 15), ("ensure", 2, 10),
           ("free", 0), ("ensure", 1, 2), ("free", 2)]
    for op in ops:
        if op[0] == "ensure":
            assert ja.ensure(op[1], op[2]) == ta.ensure(op[1], op[2]), op
        else:
            assert ja.free_slot(op[1]) == ta.free_slot(op[1]), op
        np.testing.assert_array_equal(ta.table, ja.table)
        assert ta.free == ja.free and ta.free_pages == ja.free_pages
        assert ta.pages_in_use == ja.pages_in_use
        assert ta.can_admit(2) == ja.can_admit(2)
        assert ta.pages_for(9) == ja.pages_for(9)
    ts, js = ta.stats(row_bytes=64, layers=2), ja.stats(row_bytes=64,
                                                        layers=2)
    assert ts == {k: js[k] for k in ts}


def test_logical_kv_view_matches():
    from repro.core.paging import logical_kv_view as jview
    from repro_torch.core.paging import logical_kv_view as tview
    pages = _rand(30, 5, 4, 2, 8)
    tbl = np.array([[2, 4, 0], [1, 3, 0]], np.int32)
    np.testing.assert_array_equal(
        tview(torch.from_numpy(pages), torch.from_numpy(tbl)).numpy(),
        np.asarray(jview(jnp.asarray(pages), jnp.asarray(tbl))))
