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
import torch_threads  # noqa: E402,F401  (one intra-op thread)
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


def _bf16(a):
    """Rounded to bf16 and back: products of such values are exact in fp32,
    as they are for the kernel's bf16 operands."""
    return torch.from_numpy(np.asarray(a)).to(torch.bfloat16).float()


def _chunked_plan(q, k, causal):
    from repro_torch.core.selection import select_thresholds_chunked
    return select_thresholds_chunked(q, k, 8, causal=causal, chunk=32,
                                     q_block=BLK, k_block=BLK)


def _window_case(mode, causal):
    """bf16-valued q/k, the compact plan and the selection operands of one
    mode, as the kernels take them."""
    q, k, _ = (_bf16(a) for a in _qkv(15))
    pos = torch.arange(S, dtype=torch.int32)[None, :, None].expand(BH, S, 1)
    if mode == "threshold":
        thr, bm = _chunked_plan(q, k, causal)
        sel = dict(thresholds=thr)
    elif mode == "mask":
        _, _, _, mask, bm = _mask_case(16)
        sel = dict(mask=_t(mask))
        bm = _t(bm)
    else:
        bm = torch.from_numpy(np.random.default_rng(17).random(
            (BH, S // BLK, S // BLK)) < 0.5)
        sel = {}
    if causal and mode != "mask":
        sel.update(causal=True, q_pos=pos, k_pos=pos)
    idx, cnt = tbm.compact_kv_plan(bm)
    return q, k, idx, cnt, sel


def _plain_admitted(q, k, idx, cnt, sel):
    adm = torch.zeros((BH, S), dtype=torch.int32)
    tsa.sata_block_attention_compact_ref(q, k, k, idx, cnt, q_block=BLK,
                                         k_block=BLK, admitted=adm, **sel)
    return adm


@pytest.mark.parametrize("mode,causal", [
    ("threshold", True), ("threshold", False), ("mask", False),
    ("block", True), ("block", False)])
def test_admitted_window_at_zero_slack_is_the_plain_count(mode, causal):
    """With no slack the window is the plain version's admitted count, in
    every mode; mask and block modes give it at any slack."""
    q, k, idx, cnt, sel = _window_case(mode, causal)
    adm = _plain_admitted(q, k, idx, cnt, sel)
    kw = dict(q_block=BLK, k_block=BLK, **sel)
    lo, hi = tsa.admitted_window(q, k, idx, cnt, slack=0.0, **kw)
    assert torch.equal(lo, adm) and torch.equal(hi, adm)
    if mode != "threshold":
        lo, hi = tsa.admitted_window(q, k, idx, cnt, **kw)
        assert torch.equal(lo, adm) and torch.equal(hi, adm)


def _near_threshold_case():
    """Threshold mode with each row's threshold set to the bf16 value that
    one of its causally admissible scores rounds UP to, that score lying
    1/8 to 3/8 of a bf16 ulp below it (clear of both the threshold and
    the rounding midpoint by far more than the window): bf16(s) >= thr
    admits the key, an fp32 predicate s >= thr does not.  Returns the
    case and the rows so built."""
    q, k, idx, cnt, sel = _window_case("threshold", True)
    s = torch.einsum("bqd,bkd->bqk", q, k) * float(1.0 / np.sqrt(D))
    up = s.to(torch.bfloat16).float()
    ulp = torch.ldexp(torch.ones_like(up), torch.frexp(up).exponent - 8)
    gap = up - s
    keys = torch.arange(S)
    # the window's half-width at each score (scores near 0 from large
    # cancelling products have a wide one: they are left out)
    eps = (tsa.WINDOW_SLACK * (D + 16) * 2.0 ** -24 * float(1.0 / np.sqrt(D))
           * torch.einsum("bqd,bkd->bqk", q.abs(), k.abs()))
    ok = ((gap > ulp / 8) & (gap < 3 * ulp / 8) & (ulp / 8 > 4 * eps)
          & (keys[None, None, :] <= keys[None, :, None]))
    # among those keys, the row's largest score: the threshold admits it
    # and every key above it, a handful of keys at most
    cand = torch.where(ok, s, -torch.inf)
    best = cand.argmax(-1, keepdim=True)
    rows = torch.isfinite(cand.gather(-1, best))[..., 0]
    thr = torch.where(rows[..., None], up.gather(-1, best),
                      sel["thresholds"])
    sel["thresholds"] = thr
    # plan every tile of the causal triangle so each row sees every key
    nb = S // BLK
    bm = torch.tril(torch.ones(nb, nb, dtype=torch.bool)).expand(BH, nb, nb)
    idx, cnt = tbm.compact_kv_plan(bm)
    return q, k, idx, cnt, sel, rows


def test_admitted_window_holds_another_summation_order():
    """On scores a fraction of a bf16 ulp from the thresholds, the plain
    version and a run that sums each score in another order (einsum's)
    both land inside the window."""
    q, k, idx, cnt, sel, rows = _near_threshold_case()
    assert rows.float().mean() > 0.8
    kw = dict(q_block=BLK, k_block=BLK, **sel)
    lo, hi = tsa.admitted_window(q, k, idx, cnt, **kw)
    adm = _plain_admitted(q, k, idx, cnt, sel)
    assert (lo <= adm).all() and (adm <= hi).all()
    orig = tsa._scores
    try:
        tsa._scores = lambda qt, kt: torch.einsum("...qd,...kd->...qk",
                                                  qt.float(), kt.float())
        other = _plain_admitted(q, k, idx, cnt, sel)
    finally:
        tsa._scores = orig
    assert (lo <= other).all() and (other <= hi).all()


def test_admitted_window_catches_an_fp32_predicate(monkeypatch):
    """A plain run whose predicate compares the fp32 score with bf16(thr)
    admits fewer keys than the window allows in every row built to have
    a score within half a bf16 ulp below its threshold."""
    q, k, idx, cnt, sel, rows = _near_threshold_case()
    kw = dict(q_block=BLK, k_block=BLK, **sel)
    lo, _ = tsa.admitted_window(q, k, idx, cnt, **kw)
    monkeypatch.setattr(tsa, "bisect_select", lambda s, t: s >= t.to(
        torch.bfloat16).float())
    fault = _plain_admitted(q, k, idx, cnt, sel)
    assert (fault[rows] < lo[rows]).all()


def test_library_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` changes the library's file name, so the
    kernels that include it rebuild."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build.library_path("k") != before
    assert build.library_path("k") == build.library_path("k")


def _tc_layout_program(tmp_path):
    """``tc_width`` and ``tc_layout`` of the ``.cu`` compiled with the host
    C++ compiler into a program that reads ``D q_block mask pos thr`` lines
    and prints ``width chunk warpgroups stages total limit`` for each."""
    import shutil
    import subprocess
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = (pathlib.Path(tsa.__file__).parent / "csrc" /
           "sata_attention.cu").read_text()
    a = src.index("constexpr int kTcRows")
    b = src.index("  return L;\n}\n", src.index("inline TcLayout tc_layout(")) \
        + len("  return L;\n}\n")
    prog = ("#define __host__\n#define __device__\n#include <cstdio>\n"
            + src[a:b] + """
int main() {
  int v[5];
  while (scanf("%d %d %d %d %d", v, v + 1, v + 2, v + 3, v + 4) == 5) {
    const TcLayout L = tc_layout(v[0], v[1], v[2], v[3], v[4]);
    printf("%d %d %d %d %d %d\\n", L.dk, tc_chunk(L.dk), L.nwg, L.stages,
           L.total, kMaxSmem);
  }
}
""")
    (tmp_path / "tc.cpp").write_text(prog)
    exe = tmp_path / "tc"
    subprocess.run([cxx, "-std=c++17", "-o", str(exe),
                    str(tmp_path / "tc.cpp")], check=True)

    def run(cases):
        out = subprocess.run([str(exe)], check=True, capture_output=True,
                             text=True, input="\n".join(
                                 " ".join(map(str, c)) for c in cases))
        return [tuple(map(int, line.split()))
                for line in out.stdout.splitlines()]
    return run


# the selection modes the tensor-core body is instantiated for: (mask,
# positions, thresholds)
TC_MODES = ((1, 0, 0), (0, 1, 1), (0, 0, 1), (0, 1, 0), (0, 0, 0))


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("q_block", [16, 32, 64, 80, 128])
def test_main_shapes_take_the_tensor_core_body(tmp_path, d, q_block):
    """The entry point routes bf16 on the 16-grid to the tensor cores, whose
    layout (``tc_layout``, compiled with the host C++ compiler) must fit a
    block's shared memory, 232,448 bytes: every instantiated width, in
    every selection mode and for every q-block edge (one consumer
    warpgroup up to 64 rows, two above), with 2 to 4 stages, at D <= 80
    with three at least; its swizzled rows are 64 columns (128 bytes)
    where the width is a multiple of 64, else 16."""
    run = _tc_layout_program(tmp_path)
    for (dk, w, nwg, stages, total, limit), mode in zip(
            run([(d, q_block, *m) for m in TC_MODES]), TC_MODES):
        assert limit == 232448
        assert dk == d and w == (64 if d % 64 == 0 else 16)
        assert nwg == (2 if q_block > 64 else 1)
        assert total <= limit, (mode, total)
        assert (3 if d <= 80 else 2) <= stages <= 4, (mode, stages)


@pytest.mark.parametrize("d,width", [(16, 64), (32, 64), (48, 64), (64, 64),
                                     (80, 80), (96, 128), (112, 128),
                                     (128, 128)])
def test_each_width_pads_to_its_instantiation(tmp_path, d, width):
    """D on the 16-grid takes the tensor cores at the next instantiated
    width: 64 (whisper-base's), 80 (zamba2-2.7b's) or 128, so phase 6's
    D 16 / 32 cases keep the tensor cores and D 80 computes no product
    wider than 80 columns."""
    run = _tc_layout_program(tmp_path)
    assert [r[0] for r in run([(d, 128, *m) for m in TC_MODES])] == \
        [width] * len(TC_MODES)


@pytest.mark.parametrize("layout", ["expanded", "contiguous", "int64",
                                    "sliced"])
def test_positions_reach_the_kernel_without_a_copy_when_shared(layout):
    """``_launch`` hands the kernel positions as int32 rows and a row
    stride: positions every row shares (the path's, a (1, S, 1) arange
    expanded over BH) pass uncopied with a stride of 0; any other layout
    is made contiguous (stride S).  Either way the kernel's reads
    ``pos[bh * stride + i]`` give the same values as the contiguous copy
    the wrapper made before, bit for bit."""
    bh, s = 3, 32
    base = torch.arange(s, dtype=torch.int32)
    if layout == "expanded":
        pos = base[None, :, None].expand(bh, s, 1)
    elif layout == "contiguous":
        pos = (base[None, :, None] + 5 * torch.arange(bh, dtype=torch.int32)
               [:, None, None]).contiguous()
    elif layout == "int64":
        pos = base.long()[None, :, None].expand(bh, s, 1)
    else:
        pos = torch.arange(2 * s, dtype=torch.int32).reshape(1, 2 * s, 1)[
            :, ::2].expand(bh, s, 1)
    rows, stride = tsa._rows(pos, bh, s)
    assert rows.dtype == torch.int32
    if layout == "expanded":
        assert stride == 0 and rows.data_ptr() == pos.data_ptr()
    flat = torch.as_strided(rows, (bh, s), (stride, 1))
    assert torch.equal(flat, tsa._i32(pos, (bh, s)))


def test_admission_edge_is_the_bf16_predicate(tmp_path):
    """The tensor-core body selects by ``s >= admit_edge(bf16(thr))``:
    compiled with the host C++ compiler (bf16 rounding, round to nearest
    even, as torch rounds), the edge must give ``bf16(s) >= bf16(thr)``
    for every score, at rounding midpoints, zeros, signs and infinities
    too."""
    import shutil
    import subprocess
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = (pathlib.Path(tsa.__file__).parent / "csrc" /
           "sata_attention.cu").read_text()
    a = src.index("__device__ float admit_edge(float t)")
    b = src.index("\n}\n", a) + 3
    prog = """#include <cstdint>
#include <cstdio>
#include <cstring>
#define __device__
static float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
static float bf16_rn(float x) {
  uint32_t u; memcpy(&u, &x, 4);
  u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  return __uint_as_float(u);
}
""" + src[a:b] + """
int main() {
  float t;
  while (scanf("%a", &t) == 1) printf("%a\\n", admit_edge(t));
}
"""
    rng = np.random.default_rng(18)
    thr = torch.from_numpy(np.concatenate([
        rng.standard_normal(200) * 3, [0.0, -0.0, 1e-40, -1e-40, np.inf,
                                       -np.inf, 3e38, -3e38]])
        .astype(np.float32)).to(torch.bfloat16).float()
    (tmp_path / "edge.cpp").write_text(prog)
    exe = tmp_path / "edge"
    subprocess.run([cxx, "-std=c++17", "-O1", "-o", str(exe),
                    str(tmp_path / "edge.cpp")], check=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, input="\n".join(
                             float(t).hex() for t in thr))
    edge = torch.tensor([float.fromhex(x) for x in out.stdout.split()],
                        dtype=torch.float32)
    # scores: each threshold's neighbourhood in fp32 steps, its bf16
    # rounding midpoints, and random values
    steps = torch.cat([torch.arange(-40000, 40001, 997),
                       torch.tensor([-32769, -32768, -32767, 32767, 32768,
                                     32769])])
    bits = thr.view(torch.int32)[:, None] + steps[None]
    near = bits.view(torch.float32)
    s = torch.cat([near.flatten(), near.flatten() + 2 ** -30,
                   torch.from_numpy(rng.standard_normal(4000)
                                    .astype(np.float32) * 4)])
    s = s[torch.isfinite(s)]
    for t, e in zip(thr, edge):
        want = s.to(torch.bfloat16).float() >= t
        assert torch.equal(s >= e, want), (float(t), float(e))


def _cuda_small_case(dtype, tol):
    """D 16, 16-row blocks (the JAX planner's case), every mode."""
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
        if dt == torch.bfloat16 and "thresholds" in sel:
            lo, hi = tsa.admitted_window(qc, kc, idx, cnt, q_block=BLK,
                                         k_block=BLK, **sel)
            assert ((lo <= adm_k) & (adm_k <= hi)).all()
        else:
            assert torch.equal(adm_k, adm_p)
        if "thresholds" not in sel and not sel.get("causal"):
            dense = tsa.sata_block_attention(qc, kc, vc, cu(bm),
                                             mask=sel.get("mask"),
                                             q_block=BLK, k_block=BLK)
            assert torch.equal(dense, got)


def _cuda_width_case(d, mode, tol):
    """bf16 at head width d, 128 x 128 tiles, one selection mode; outputs
    within ``tol`` of the plain version's."""
    from repro_torch.core.selection import select_thresholds_chunked
    bh, s = 4, 512
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).cuda().to(torch.bfloat16) for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32, device="cuda")[None, :, None] \
        .expand(bh, s, 1)
    if mode == "threshold":
        thr, bm = select_thresholds_chunked(q, k, 64, causal=True, chunk=s,
                                            q_block=128, k_block=128)
        sel = dict(thresholds=thr, causal=True, q_pos=pos, k_pos=pos)
    elif mode == "mask":
        mask = torch.from_numpy(rng.random((bh, s, s)) < 0.1).cuda()
        mask[0, :64] = False
        bm = tbm.block_occupancy(mask, 128, 128)
        sel = dict(mask=mask)
    else:
        bm = torch.from_numpy(rng.random((bh, s // 128, s // 128)) < 0.5) \
            .cuda()
        sel = dict(causal=True, q_pos=pos, k_pos=pos)
    idx, cnt = tbm.compact_kv_plan(bm)
    adm_k = torch.zeros((bh, s), dtype=torch.int32, device="cuda")
    adm_p = torch.zeros_like(adm_k)
    got = tsa.sata_block_attention_compact(q, k, v, idx, cnt, admitted=adm_k,
                                           **sel)
    want = tsa.sata_block_attention_compact_ref(q, k, v, idx, cnt,
                                                admitted=adm_p, **sel)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= tol
    if mode == "threshold":
        lo, hi = tsa.admitted_window(q, k, idx, cnt, **sel)
        assert ((lo <= adm_k) & (adm_k <= hi)).all()
    else:
        assert torch.equal(adm_k, adm_p)
    if mode == "mask":
        dense = tsa.sata_block_attention(q, k, v, bm, mask=sel["mask"])
        assert torch.equal(dense, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,d", [
    ("float32", 1e-5, 16), ("bfloat16", 2e-2, 16), ("bfloat16", 2e-2, 64),
    ("bfloat16", 2e-2, 80), ("bfloat16", 2e-2, 128)])
def test_cuda_kernels_match_plain_versions(dtype, tol, d):
    """Needs a CUDA GPU (and nvcc): both kernels against their plain
    versions in every mode, and the compacted grid == the dense grid
    bitwise on the same plan: at D 16 in fp32 and bf16, and in bf16 at
    each width the tensor-core body is instantiated for (64, 80, 128) in
    threshold, mask and block mode.  Admitted-key counts: equal to the
    plain version's, except bf16 threshold mode, where the tensor cores
    sum each score in their own order and every row's count must lie in
    ``admitted_window``.  Tolerances: fp32 summation order; bf16 output
    rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    if d == 16:
        _cuda_small_case(dtype, tol)
    else:
        for mode in ("threshold", "mask", "block"):
            _cuda_width_case(d, mode, tol)
