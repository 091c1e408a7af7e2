"""Port parity: the SATA block-sparse attention kernels (compacted grid B3
and dense grid B4) and ``kernels.ops.sata_attention``, against the JAX
reference on the same numpy inputs.

On the CPU the port runs the kernels' plain versions; the JAX side runs
its Pallas kernels in interpret mode, as the JAX tests do.  fp32, atol
1e-5: the two sides differ only in the order of fp32 sums (dot
products, softmax sums, the PV product).  The CUDA kernel itself is held
against the plain version by the ``cuda``-marked test (it runs on a GPU
machine and skips elsewhere) and by ``chip_smoke.py``."""
import ctypes
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import blockmap as jbm  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import sata_attention as jsa  # noqa: E402
from repro_torch.core import blockmap as tbm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sata_attention as tsa  # noqa: E402
from repro_torch.kernels import sata_decode as tsd  # noqa: E402

ATOL = 1e-5          # fp32 summation order
BH, S, D, BLK = 4, 64, 16, 16


def _qkv(seed, bh=BH, s=S, d=D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((bh, s, d)).astype(np.float32)
                 for _ in range(3))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _threshold_case(seed, causal):
    """q/k/v, the chunked planner's thresholds and block map (JAX's), and
    positions as the kernel takes them."""
    q, k, v = _qkv(seed)
    thr, bm = jsel.select_thresholds_chunked(
        jnp.asarray(q), jnp.asarray(k), 8, causal=causal, chunk=32,
        q_block=BLK, k_block=BLK)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, :, None],
                          (BH, S, 1))
    return q, k, v, np.asarray(thr), np.asarray(bm), pos


def _mask_case(seed):
    q, k, v = _qkv(seed)
    rng = np.random.default_rng(seed + 50)
    mask = rng.random((BH, S, S)) < 0.15
    mask[1, :16] = False                         # rows with no key at all
    bm = np.asarray(jbm.block_occupancy(jnp.asarray(mask), BLK, BLK))
    return q, k, v, mask, bm


def _run_both(q, k, v, bm, *, pad_to=None, **sel):
    """B3 on both sides over compact_kv_plan(bm) with the same selection
    operands; returns (port, reference, port admitted counts)."""
    idx, cnt = jbm.compact_kv_plan(jnp.asarray(bm), pad_to=pad_to,
                                   truncate=pad_to is not None)
    want = jsa.sata_block_attention_compact(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), idx, cnt,
        q_block=BLK, k_block=BLK, interpret=True,
        **{n: (a if isinstance(a, bool) else jnp.asarray(a))
           for n, a in sel.items()})
    adm = torch.zeros((BH, S), dtype=torch.int32)
    got = tsa.sata_block_attention_compact_ref(
        _t(q), _t(k), _t(v), _t(idx), _t(cnt), q_block=BLK, k_block=BLK,
        admitted=adm,
        **{n: (a if isinstance(a, bool) else _t(a)) for n, a in sel.items()})
    return got, want, adm


@pytest.mark.parametrize("causal", [True, False])
def test_compact_threshold_mode_matches(causal):
    q, k, v, thr, bm, pos = _threshold_case(0, causal)
    sel = dict(thresholds=thr, causal=causal)
    if causal:
        sel.update(q_pos=pos, k_pos=pos)
    got, want, adm = _run_both(q, k, v, bm, **sel)
    _close(got, want)
    # admitted keys per row: the bisect predicate over all keys (every
    # selected key lies in an occupied tile by construction of the map)
    sc = np.einsum("bqd,bkd->bqk", q, k) / np.sqrt(D)
    keep = np.array(jbm.bisect_select(jnp.asarray(sc), jnp.asarray(thr)))
    if causal:
        keep &= np.tril(np.ones((S, S), bool))[None]
    np.testing.assert_array_equal(adm.numpy(), keep.sum(-1))
    # the bisect invariant: at least top-k keys wherever k are admissible
    assert (adm.numpy() >= np.minimum(8, np.arange(1, S + 1) if causal
                                      else S)).all()


def test_compact_mask_mode_matches():
    q, k, v, mask, bm = _mask_case(1)
    got, want, adm = _run_both(q, k, v, bm, mask=mask)
    _close(got, want)
    np.testing.assert_array_equal(adm.numpy(), mask.sum(-1))
    assert not got[1, :16].any()                 # no admissible key: zeros


@pytest.mark.parametrize("causal", [True, False])
def test_compact_block_mode_matches(causal):
    q, k, v = _qkv(2)
    rng = np.random.default_rng(3)
    bm = rng.random((BH, S // BLK, S // BLK)) < 0.5
    bm[2] = False                                # an all-empty batch entry
    sel = dict(causal=causal)
    if causal:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, :, None],
                              (BH, S, 1))
        sel.update(q_pos=pos, k_pos=pos)
    got, want, _ = _run_both(q, k, v, bm, **sel)
    _close(got, want)
    if not causal:
        _close(got, tref.ref_block_attention(_t(q), _t(k), _t(v), _t(bm),
                                             q_block=BLK, k_block=BLK))
        _close(tref.ref_dense_attention(_t(q), _t(k), _t(v)),
               jref.ref_dense_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v)))


def test_compact_with_padded_and_truncated_slots_matches():
    q, k, v, thr, bm, pos = _threshold_case(4, True)
    got, want, _ = _run_both(q, k, v, bm, pad_to=2, thresholds=thr,
                             causal=True, q_pos=pos, k_pos=pos)
    _close(got, want)


def test_compact_zero_slots_gives_zeros():
    q, k, v = _qkv(5)
    idx = np.zeros((BH, S // BLK, 0), np.int32)
    cnt = np.zeros((BH, S // BLK), np.int32)
    want = jsa.sata_block_attention_compact(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx),
        jnp.asarray(cnt), q_block=BLK, k_block=BLK, interpret=True)
    got = tsa.sata_block_attention_compact_ref(
        _t(q), _t(k), _t(v), _t(idx), _t(cnt), q_block=BLK, k_block=BLK)
    _close(got, want)
    assert not got.any()


@pytest.mark.parametrize("with_mask", [True, False])
def test_dense_grid_matches(with_mask):
    q, k, v, mask, bm = _mask_case(6)
    if not with_mask:
        bm = np.random.default_rng(7).random(bm.shape) < 0.4
    m = mask if with_mask else None
    want = jsa.sata_block_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bm),
        mask=None if m is None else jnp.asarray(m), q_block=BLK,
        k_block=BLK, interpret=True)
    got = tsa.sata_block_attention_ref(
        _t(q), _t(k), _t(v), _t(bm), mask=None if m is None else _t(m),
        q_block=BLK, k_block=BLK)
    _close(got, want)
    # the compacted grid on the same plan gives the same bits
    idx, cnt = tbm.compact_kv_plan(_t(bm))
    same = tsa.sata_block_attention_compact_ref(
        _t(q), _t(k), _t(v), idx, cnt, mask=None if m is None else _t(m),
        q_block=BLK, k_block=BLK)
    assert torch.equal(got, same)


def test_argument_checks_raise():
    q, k, v, thr, bm, pos = _threshold_case(8, True)
    idx, cnt = tbm.compact_kv_plan(_t(bm))
    args = (_t(q), _t(k), _t(v), idx, cnt)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tsa.sata_block_attention_compact_ref(
            *args, mask=torch.ones(BH, S, S, dtype=torch.bool),
            thresholds=_t(thr), q_block=BLK, k_block=BLK)
    with pytest.raises(ValueError, match="q_pos/k_pos"):
        tsa.sata_block_attention_compact_ref(
            *args, thresholds=_t(thr), causal=True, q_block=BLK,
            k_block=BLK)
    with pytest.raises(ValueError, match="tile by the block"):
        tsa.sata_block_attention_ref(_t(q), _t(k), _t(v), _t(bm),
                                     q_block=24, k_block=BLK)


def test_cuda_wrappers_never_take_the_plain_version():
    """The CUDA wrappers refuse CPU tensors instead of computing them,
    and a launch count moves only on a real launch."""
    q, k, v, thr, bm, pos = _threshold_case(9, False)
    idx, cnt = tbm.compact_kv_plan(_t(bm))
    before = (tsa.sata_block_attention_compact.launches,
              tsa.sata_block_attention.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsa.sata_block_attention_compact(_t(q), _t(k), _t(v), idx, cnt,
                                         thresholds=_t(thr), q_block=BLK,
                                         k_block=BLK)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsa.sata_block_attention(_t(q), _t(k), _t(v), _t(bm), q_block=BLK,
                                 k_block=BLK)
    assert (tsa.sata_block_attention_compact.launches,
            tsa.sata_block_attention.launches) == before


@pytest.mark.parametrize("src,symbol,module", [
    ("sata_attention.cu", "sata_block_attention", tsa),
    ("sata_decode.cu", "sata_decode_attention", tsd)])
def test_ctypes_signature_matches_the_c_interface(src, symbol, module):
    """The wrapper's ``argtypes`` list the C function's parameters, in
    order: a pointer for each ``void*``/pointer and ``c_int`` for each
    ``int`` (ctypes checks the count only against ``argtypes``)."""
    text = (pathlib.Path(tsa.__file__).parent / "csrc" / src).read_text()
    sig = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)", text,
                    re.S).group(1)
    kinds = [ctypes.c_void_p if "*" in a else ctypes.c_int
             for a in sig.split(",")]
    assert module.ARGTYPES == kinds


def _dense_sel(seed, causal=True):
    q, k, v = _qkv(seed)
    sc = np.einsum("bqd,bkd->bqk", q, k) / np.sqrt(D)
    if causal:
        sc = np.where(np.tril(np.ones((S, S), bool))[None], sc, -2.0 ** 30)
    kth = -np.sort(-sc, axis=-1)[..., 7:8]
    sel = sc >= kth
    if causal:
        sel &= np.tril(np.ones((S, S), bool))[None]
    return q, k, v, sel


@pytest.mark.parametrize("schedule", ["compact", "dense"])
@pytest.mark.parametrize("use_sata,exact", [(True, True), (False, True),
                                            (True, False)])
def test_sata_attention_dense_selection_matches(schedule, use_sata, exact):
    q, k, v, sel = _dense_sel(10)
    kw = dict(q_block=BLK, k_block=BLK, use_sata=use_sata, exact=exact,
              schedule=schedule)
    want, bm_w = jops.sata_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(sel), **kw)
    got, bm_g = tops.sata_attention(_t(q), _t(k), _t(v), _t(sel), **kw)
    _close(got, want)
    np.testing.assert_array_equal(bm_g.numpy(), np.asarray(bm_w))
    if exact:
        _close(got, tops.sata_attention_reference(_t(q), _t(k), _t(v),
                                                  _t(sel)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("max_kv_blocks,on_exceed", [
    (None, "truncate"), (2, "dense"), (4, "dense"), (2, "truncate")])
def test_sata_attention_chunked_matches(causal, max_kv_blocks, on_exceed):
    q, k, v = _qkv(11)
    kw = dict(q_block=BLK, k_block=BLK, selection="chunked", topk_k=8,
              causal=causal, sel_chunk=32, max_kv_blocks=max_kv_blocks,
              on_exceed=on_exceed)
    want, bm_w = jops.sata_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw)
    got, bm_g = tops.sata_attention(_t(q), _t(k), _t(v), **kw)
    _close(got, want)
    np.testing.assert_array_equal(bm_g.numpy(), np.asarray(bm_w))


def test_sata_attention_argument_checks_raise():
    q, k, v, sel = _dense_sel(12)
    a = (_t(q), _t(k), _t(v))
    for kw, msg in ((dict(schedule="x"), "unknown schedule"),
                    (dict(selection="x"), "unknown selection"),
                    (dict(on_exceed="x"), "unknown on_exceed"),
                    (dict(selection="chunked", schedule="dense"),
                     "compact schedule"),
                    (dict(), "needs scores_mask"),
                    (dict(selection="chunked"), "needs topk_k")):
        with pytest.raises(ValueError, match=msg):
            tops.sata_attention(*a, q_block=BLK, k_block=BLK, **kw)
    with pytest.raises(ValueError, match="chunked-only"):
        tops.sata_attention(*a, _t(sel), q_block=BLK, k_block=BLK,
                            causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_kernels_match_plain_versions(dtype, tol):
    """Needs a CUDA GPU (and nvcc): both kernels against their plain
    versions in every mode, with equal admitted-key counts, and the
    compacted grid == the dense grid bitwise on the same plan.
    Tolerances: fp32 summation order; bf16 output rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v, thr, bm, pos = _threshold_case(13, True)
    cu = lambda a: _t(a).cuda()                      # noqa: E731
    qc, kc, vc = (cu(a).to(dt) for a in (q, k, v))
    idx, cnt = tbm.compact_kv_plan(cu(bm))
    cases = [dict(thresholds=cu(thr), causal=True, q_pos=cu(pos),
                  k_pos=cu(pos)),
             dict(thresholds=cu(thr)),
             dict(mask=cu(_mask_case(14)[3])),
             dict(causal=True, q_pos=cu(pos), k_pos=cu(pos)), dict()]
    for sel in cases:
        adm_k = torch.zeros((BH, S), dtype=torch.int32, device="cuda")
        adm_p = torch.zeros_like(adm_k)
        got = tsa.sata_block_attention_compact(
            qc, kc, vc, idx, cnt, q_block=BLK, k_block=BLK, admitted=adm_k,
            **sel)
        want = tsa.sata_block_attention_compact_ref(
            qc, kc, vc, idx, cnt, q_block=BLK, k_block=BLK, admitted=adm_p,
            **sel)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) <= tol
        assert torch.equal(adm_k, adm_p)
        if "thresholds" not in sel and not sel.get("causal"):
            dense = tsa.sata_block_attention(qc, kc, vc, cu(bm),
                                             mask=sel.get("mask"),
                                             q_block=BLK, k_block=BLK)
            assert torch.equal(dense, got)
