"""The decode kernel's split of a row over a thread-block cluster.

Past G = 8 the CUDA kernel (``csrc/sata_decode.cu``) splits each (slot,
KV head) row's plan entries over ``launch_config(...).cluster`` blocks:
share r holds entries [r·per, min(count, (r + 1)·per)), per = ⌈count /
cs⌉, runs its own online softmax, and the shares combine in rank order.
``sata_decode_attention_ref(splits=s)`` is the plain model of that
arithmetic.  Here, on the CPU, it is held to the JAX Pallas kernel in
interpret mode (fp32 1e-5; bf16 2e-2: a share rounds p against its own
running max, one bf16 step of p), ``splits=1`` to the unsplit plain
version bitwise, the shares that may be empty to the unsplit version,
the partial mode combined alone to the default mode's bits, and a row's
result to the row alone (not the grid it is computed in).  The
``cuda``-marked test holds the kernel to the model on a GPU."""
import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax.numpy as jnp  # noqa: E402

from repro.core import decode_plan as jdp  # noqa: E402
from repro.core.paging import PageAllocator as JAlloc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.blockmap import bisect_select  # noqa: E402
from repro_torch.core.selection import NEG_INF  # noqa: E402
from repro_torch.distributed.sharding import KeySplit  # noqa: E402
from repro_torch.kernels import sata_decode as tsd  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SPLITS = [1, 2, 4, 8]


def _case(seed, g, *, b=3, kv=2, d=16, blk=8, s=64, pos=(63, 21, 5),
          topk=4):
    """Random q/K/V, the reference planner's plan over them, and the
    same cache laid out as a page pool."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    idx, cnt, thr = (np.array(a) for a in jdp.full_replan(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), topk_k=topk,
        k_block=blk, plan_blocks=s // blk))
    alloc = JAlloc(b * (s // blk) + 1, b, s // blk, blk, audit=False)
    for i in range(b):
        assert alloc.ensure(i, s - 1)
    kp = np.zeros((alloc.n_pages, blk, kv, d), np.float32)
    vp = np.zeros_like(kp)
    for i in range(b):
        for lp in range(s // blk):
            kp[alloc.table[i, lp]] = k[i, lp * blk:(lp + 1) * blk]
            vp[alloc.table[i, lp]] = v[i, lp * blk:(lp + 1) * blk]
    return dict(q=q, k=k, v=v, kp=kp, vp=vp, table=alloc.table.copy(),
                idx=idx, cnt=cnt, thr=thr, pos=pos, blk=blk)


def _round(c, dtype):
    """The case with q/K/V rounded to ``dtype`` (numpy fp32 arrays)."""
    if dtype == "float32":
        return c
    c = dict(c)
    for n in ("q", "k", "v", "kp", "vp"):
        c[n] = np.asarray(jnp.asarray(c[n]).astype(jnp.bfloat16), np.float32)
    return c


def _args(c, paged, dtype="float32", device="cpu"):
    t = {n: torch.from_numpy(np.ascontiguousarray(c[n])).to(device)
         for n in ("q", "k", "v", "kp", "vp", "idx", "cnt", "thr", "pos",
                   "table")}
    for n in ("q", "k", "v", "kp", "vp"):
        t[n] = t[n].to(getattr(torch, dtype))
    kk, vv = (t["kp"], t["vp"]) if paged else (t["k"], t["v"])
    return (t["q"], kk, vv, t["idx"], t["cnt"], t["thr"], t["pos"]), dict(
        k_block=c["blk"], page_table=t["table"] if paged else None)


def _unsplit(q, k, v, kv_indices, kv_counts, thresholds, pos, *, k_block,
             page_table=None, partial=False):
    """The plain version as it stood before the split (one online
    softmax over the row's plan entries, ``o / l`` at the end): the
    oracle ``splits=1`` must equal bitwise."""
    b, n_kv, g, d = q.shape
    p = kv_indices.shape[-1]
    if p == 0:
        if partial:
            return (torch.zeros(q.shape, dtype=torch.float32,
                                device=q.device),
                    torch.full((b, n_kv, g, 1), float("-inf"),
                               device=q.device))
        return torch.zeros_like(q)
    scale = float(1.0 / np.sqrt(d))
    dev = q.device
    qf = q.float()
    thr = thresholds.float()
    acc = torch.zeros((b, n_kv, g, d), dtype=torch.float32, device=dev)
    m = torch.full((b, n_kv, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n_kv, g, 1), dtype=torch.float32, device=dev)
    ti = torch.arange(k_block, device=dev)
    hi = torch.arange(n_kv, device=dev)[None, :, None]
    for j in range(p):
        blk = kv_indices[..., j].long()
        kpos = blk[..., None] * k_block + ti
        if page_table is None:
            bi = torch.arange(b, device=dev)[:, None, None]
            kt, vt = k[bi, kpos, hi], v[bi, kpos, hi]
        else:
            phys = torch.gather(page_table.long(), 1, blk)[..., None]
            kt, vt = k[phys, ti, hi], v[phys, ti, hi]
        s = torch.einsum("bkgd,bktd->bkgt", qf, kt.float()) * scale
        mask = bisect_select(s, thr) & (kpos <= pos[:, None, None])[:, :, None]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        pe = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + pe.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum(
            "bkgt,bktd->bkgd", pe.to(v.dtype).float(), vt.float())
        live = (j < kv_counts)[..., None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    if partial:
        return out, torch.where(
            l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), float("-inf"))
    return out.to(q.dtype)


@functools.cache
def _jax_case(g, paged, dtype):
    """Case G's inputs and the JAX Pallas kernel's output on them (built
    on first use, not while the module is collected)."""
    c = _round(_case(50 + g, g, pos=(63, 30, 9)), dtype)
    k, v = (c["kp"], c["vp"]) if paged else (c["k"], c["v"])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jops.sata_decode_attention(
        jnp.asarray(c["q"], jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(c["idx"]), jnp.asarray(c["cnt"]), jnp.asarray(c["thr"]),
        jnp.asarray(c["pos"]), k_block=c["blk"],
        page_table=jnp.asarray(c["table"]) if paged else None,
        interpret=True).astype(jnp.float32))
    return c, want


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("g", [4, 12, 16])
def test_split_model_matches_jax(g, paged, dtype, splits):
    """The split model against the reference's Pallas kernel (interpret
    mode) at G 4, 12 and 16, both layouts; 3 slots x 2 KV heads whose
    2-6 planned blocks leave shares empty at 4 and 8 splits."""
    c, want = _jax_case(g, paged, dtype)
    args, kw = _args(c, paged, dtype)
    got = tsd.sata_decode_attention_ref(*args, splits=splits, **kw)
    assert got.shape == want.shape == (3, 2, g, 16)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=0)
    other, kw2 = _args(c, not paged, dtype)
    assert torch.equal(got, tsd.sata_decode_attention_ref(
        *other, splits=splits, **kw2))


@pytest.mark.parametrize("partial", [False, True], ids=["default", "partial"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("g", [1, 4, 16])
def test_one_split_is_the_unsplit_version_bitwise(g, paged, dtype, partial):
    c = _round(_case(70 + g, g, pos=(63, 40, 12)), dtype)
    c["cnt"][0, 1] = 0                          # a row with no plan entry
    args, kw = _args(c, paged, dtype)
    got = tsd.sata_decode_attention_ref(*args, splits=1, partial=partial,
                                        **kw)
    want = _unsplit(*args, partial=partial, **kw)
    for a, b in zip(*((got, want) if partial else ((got,), (want,)))):
        assert torch.equal(a, b)


def _empty_share_case(dtype):
    """G 16, 4 slots x 2 KV heads over 12 blocks of 8: row (0, 0) has no
    plan entry; (0, 1) one and (1, 0) three, fewer than 4 or 8 shares;
    (1, 1) plans four blocks of which only the third holds keys <= pos,
    so every admitted key lies in one share of 4 (and of 2, of 8); the
    other rows keep their plans."""
    c = _round(_case(90, 16, b=4, s=96, pos=(95, 20, 60, 33), topk=6),
               dtype)
    c["cnt"][0, 0], c["cnt"][0, 1] = 0, 1
    c["cnt"][1, 0] = min(3, int(c["cnt"][1, 0]))
    c["idx"][1, 1, :4] = [5, 6, 0, 7]
    c["cnt"][1, 1] = 4
    return c


@pytest.mark.parametrize("splits", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_empty_shares_against_the_unsplit_version(paged, dtype, splits):
    """Shares with no plan entry, or whose entries admit no key, add
    nothing: each row within TOL of the unsplit version, the count-0 row
    0 (lse −inf in the partial mode), and the rows whose admitted keys
    all lie in one share bitwise the unsplit version (that share runs the
    unsplit loop's steps; the other shares' blocks leave it as it was)."""
    c = _empty_share_case(dtype)
    args, kw = _args(c, paged, dtype)
    got = tsd.sata_decode_attention_ref(*args, splits=splits, **kw)
    want = _unsplit(*args, **kw)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=TOL[dtype], rtol=0)
    assert not got[0, 0].any()
    assert torch.equal(got[0, 1], want[0, 1])       # one entry: one share
    assert torch.equal(got[1, 1], want[1, 1]) and got[1, 1].any()
    if not paged:
        out, lse = tsd.sata_decode_attention_ref(*args, splits=splits,
                                                 partial=True, **kw)
        assert torch.isneginf(lse[0, 0]).all() and not out[0, 0].any()
        w_out, w_lse = _unsplit(*args, partial=True, **kw)
        dead = torch.isneginf(w_lse)
        assert torch.equal(torch.isneginf(lse), dead)
        assert float((out - w_out).abs().max()) <= TOL[dtype]
        assert float((lse - w_lse)[~dead].abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_combined_alone_is_the_default_mode(dtype, splits):
    """The partial mode's (out, lse) through ``KeySplit.combine`` on one
    rank, rounded to the cache dtype, equal to the default mode's bits
    (one combine code path)."""
    c = _empty_share_case(dtype)
    args, kw = _args(c, False, dtype)
    out, lse = tsd.sata_decode_attention_ref(*args, splits=splits,
                                             partial=True, **kw)
    whole = tsd.sata_decode_attention_ref(*args, splits=splits, **kw)
    one = KeySplit(make_local_mesh(device="cpu")).combine(out, lse)
    assert torch.equal(one.to(whole.dtype), whole)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_a_rows_split_does_not_depend_on_the_grid(paged, dtype):
    """The cluster comes from the shape alone (``launch_config`` takes G,
    D, k_block and the dtype, no batch or head count): the split model of
    each row computed in a batch of B·KV = 32 rows (4 slots x 8 KV
    heads) equals bitwise the same rows computed as one tensor-parallel
    rank's 4 of the 8 KV heads."""
    assert list(inspect.signature(tsd.launch_config).parameters) == [
        "g", "d", "k_block", "dtype"]
    c = _round(_case(33, 16, b=4, kv=8, pos=(63, 17, 40, 50)), dtype)
    splits = tsd.launch_config(16, 16, c["blk"], getattr(torch, dtype)).cluster
    assert splits > 1
    args, kw = _args(c, paged, dtype)
    whole = tsd.sata_decode_attention_ref(*args, splits=splits, **kw)
    q, k, v, idx, cnt, thr, pos = args
    heads = slice(4, 8)
    rank = (q[:, heads].contiguous(), k[:, :, heads].contiguous(),
            v[:, :, heads].contiguous(), idx[:, heads].contiguous(),
            cnt[:, heads].contiguous(), thr[:, heads].contiguous(), pos)
    part = tsd.sata_decode_attention_ref(*rank, splits=splits, **kw)
    assert torch.equal(part, whole[:, heads])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_config_clusters_by_g(dtype):
    """One block a row at G = 1, a cluster of four past G = 8 in bf16
    (two blocks an SM) and of two otherwise, at every width and page:
    portable cluster sizes, from G and the dtype alone."""
    dt = getattr(torch, dtype)
    for g, d, kb in ((g, d, kb) for g in range(1, 17) for d in (16, 80, 128)
                     for kb in (8, 64, 128)):
        cs = tsd.launch_config(g, d, kb, dt).cluster
        want = 1 if g == 1 else 4 if g > 8 and dtype == "bfloat16" else 2
        assert cs == tsd.cluster_for(g, dt.itemsize) == want, (g, d, kb, cs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_the_split_model(dtype):
    """Needs a CUDA GPU (and nvcc): the kernel at G 16 on the empty-share
    case and at the serving widths (D 128, page 64) against the split
    model within TOL (bf16: at most 1% of the outputs off its bits) and
    the unsplit version within TOL, paged == contiguous bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import ops as tops
    cases = [_empty_share_case(dtype),
             _round(_case(77, 16, b=2, kv=2, d=128, blk=64, s=256,
                          pos=(200, 90), topk=16), dtype)]
    for c in cases:
        outs = []
        for paged in (False, True):
            args, kw = _args(c, paged, dtype, "cuda")
            splits = tsd.launch_config(16, args[0].shape[3], c["blk"],
                                       args[0].dtype).cluster
            got = tops.sata_decode_attention(*args, **kw)
            model = tsd.sata_decode_attention_ref(*args, splits=splits, **kw)
            want = tsd.sata_decode_attention_ref(*args, **kw)
            torch.cuda.synchronize()
            for w in (model, want):
                assert float((got.float() - w.float()).abs().max()) \
                    <= TOL[dtype]
            if dtype == "bfloat16":
                assert float((got != model).float().mean()) <= 0.01
            outs.append(got)
        assert torch.equal(outs[0], outs[1])
