"""Port parity: the selective-mask generator, the roofline's occupancy
maps and the kernel roofline, and the two port examples.

* ``topk_mask`` equals ``jax.lax.top_k``'s selection exactly, ties
  included (the lower key index wins), on scores with planted ties and
  on a causal trace, whose early rows are mostly the ``-1e30`` fill.
* ``_compose_scores`` on JAX's own draws (``jax.random.split`` and
  ``normal`` / ``randint``, as ``repro.core.masks.synthetic_scores``
  draws them) gives the reference's scores within COMPOSE_RTOL of
  ``max(|score|, 1)`` — one fp32 rounding of the band and noise sums
  (``exp`` and the rank sum differ in the last bit) — and equal masks.
  A row whose k-th / (k+1)-th score gap were below that error could
  flip; such rows are counted and must be 0.
* ``fixed_occupancy_map`` equals the reference's for equal numpy
  generators; ``analyse_kernel``'s fetch block equals the committed
  ``results/roofline`` files (read, never rewritten), and its terms are
  the reference's operations and bytes over the H100's peaks."""
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import blockmap as jbm  # noqa: E402
from repro.core import masks as jm  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core import blockmap as tbm  # noqa: E402
from repro_torch.core import masks as tm  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMPOSE_RTOL = 1e-6
TPU_PEAK_FLOPS, TPU_HBM_BW = 197e12, 819e9    # the reference's divisors

# every kind of trace term at one shape (N 64, 3 heads), so JAX compiles
# each eager op once: the workloads' rank-1 cluster (TTST), rank-2 with a
# band (KVT), the block-quantised band (DRSformer), discrete clusters
# (the quickstart's kernel trace) and a causal fill
TRACES = {
    "cluster_rank": tm.SyntheticTrace(n_tokens=64, k=32, cluster_rank=1,
                                      cluster_scale=5.0, noise=0.2),
    "band": tm.SyntheticTrace(n_tokens=64, k=16, cluster_rank=2,
                              band_width=15.0, band_scale=2.5),
    "block_quant": tm.SyntheticTrace(n_tokens=64, k=16, cluster_rank=2,
                                     cluster_scale=0.5, band_width=6.0,
                                     band_scale=4.0, block_quant=12,
                                     noise=0.45),
    "discrete_clusters": tm.SyntheticTrace(n_tokens=64, k=8,
                                           cluster_scale=3.0,
                                           discrete_clusters=4, noise=0.3),
    "causal": tm.SyntheticTrace(n_tokens=64, k=8, cluster_rank=2,
                                band_width=6.0, band_scale=2.0,
                                causal=True),
}


def jax_draws(seed, trace, n_heads):
    """The reference's draws (``src/repro/core/masks.py:72-96``)."""
    k_q, k_k, k_n = jax.random.split(jax.random.PRNGKey(seed), 3)
    n = trace.n_tokens
    if trace.discrete_clusters > 0:
        c = trace.discrete_clusters
        q = jax.random.randint(k_q, (n_heads, n), 0, c)
        k = jax.random.randint(k_k, (n_heads, n), 0, c)
    else:
        q = jax.random.normal(k_q, (n_heads, n, trace.cluster_rank))
        k = jax.random.normal(k_k, (n_heads, n, trace.cluster_rank))
    noise = jax.random.normal(k_n, (n_heads, n, n))
    return tuple(torch.from_numpy(np.array(x)) for x in (q, k, noise))


def jax_topk(scores, k):
    return np.asarray(jm.topk_mask(jnp.asarray(scores), k))


def port_topk(scores, k):
    return tm.topk_mask(torch.from_numpy(np.array(scores)), k).numpy()


@pytest.mark.parametrize("k", [1, 5, 13, 40, 41])
def test_topk_mask_keeps_top_k_tie_order(k):
    """Integer scores in 0..3 over 40 keys: every row is full of ties,
    one row is constant.  The same keys as ``jax.lax.top_k`` keeps."""
    rng = np.random.default_rng(k)
    s = rng.integers(0, 4, size=(2, 16, 40)).astype(np.float32)
    s[1, 3] = 1.0
    got, want = port_topk(s, k), jax_topk(s, k)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == min(k, 40)).all()
    if k < 40:   # the constant row keeps its first k keys
        assert got[1, 3, :k].all() and not got[1, 3, k:].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_mask_on_a_causal_trace_matches_jax(seed):
    """The reference's causal scores: row i has i + 1 real scores and
    N - i - 1 fill values, so the first k - 1 rows take k - i - 1 keys
    from a tie at -1e30 — the lowest indices past i, in both."""
    tr = TRACES["causal"]
    s = np.asarray(jm.synthetic_scores(jax.random.PRNGKey(seed), tr, 3))
    got, want = port_topk(s, tr.k), jax_topk(s, tr.k)
    np.testing.assert_array_equal(got, want)
    for i in range(tr.k - 1):
        assert got[:, i, :tr.k].all() and not got[:, i, tr.k:].any()


@pytest.mark.parametrize("kind", list(TRACES))
@pytest.mark.parametrize("seed", [0, 1])
def test_composition_on_jax_draws_matches_reference(kind, seed):
    tr = TRACES[kind]
    n_heads = 3
    want = np.asarray(jm.synthetic_scores(jax.random.PRNGKey(seed), tr,
                                          n_heads))
    got = tm._compose_scores(tr, *jax_draws(seed, tr, n_heads)).numpy()
    scale = np.maximum(np.abs(want), 1.0)
    err = np.abs(got - want) / scale
    assert err.max() <= COMPOSE_RTOL, err.max()
    top = -np.sort(-want, axis=-1)
    gap = (top[..., tr.k - 1] - top[..., tr.k]) / scale[..., 0]
    assert int(((gap > 0) & (gap <= 2 * COMPOSE_RTOL)).sum()) == 0
    np.testing.assert_array_equal(port_topk(got, tr.k),
                                  jax_topk(want, tr.k))


@pytest.mark.parametrize("kind", list(TRACES))
def test_synthetic_masks_are_seeded_top_k_on_the_cpu(kind):
    """The public generator: exactly k keys a row (causal rows: none in
    the future once a row has k past keys), one seed one mask set, and
    ``synthetic_scores`` equal to the composition of the host draws."""
    tr = TRACES[kind]
    m = tm.synthetic_masks(0, tr, 2, device="cpu")
    assert m.dtype == bool and m.shape == (2, tr.n_tokens, tr.n_tokens)
    assert (m.sum(-1) == tr.k).all()
    np.testing.assert_array_equal(
        m, tm.synthetic_masks(0, tr, 2, device="cpu"))
    assert (m != tm.synthetic_masks(1, tr, 2, device="cpu")).any()
    if tr.causal:
        assert not np.triu(m[:, tr.k:], k=tr.k + 1).any()
    g = torch.Generator().manual_seed(5)
    got = tm.synthetic_scores(g, tr, 2, device="cpu")
    draws = tm._draws(torch.Generator().manual_seed(5), tr, 2)
    assert torch.equal(got, tm._compose_scores(tr, *draws))


def test_synthetic_masks_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        tm.synthetic_masks(0, TRACES["band"], 1)


@pytest.mark.parametrize("bh,nqb,nkb,occ", [(8, 16, 16, 4), (3, 5, 9, 9),
                                           (2, 4, 7, 1)])
def test_fixed_occupancy_map_matches_reference(bh, nqb, nkb, occ):
    got = tbm.fixed_occupancy_map(np.random.default_rng(7), bh, nqb, nkb,
                                  occ)
    want = jbm.fixed_occupancy_map(np.random.default_rng(7), bh, nqb, nkb,
                                   occ)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == occ).all()


@pytest.mark.parametrize("occ", ["0.25", "0.5", "0.75"])
def test_analyse_kernel_matches_committed_reference(occ, tmp_path):
    name = f"sata_kernel__s2048_b128_occ{occ}.json"
    committed = ROOT / "results" / "roofline" / name
    before = committed.read_bytes()
    ref = json.loads(before)
    out = troof.analyse_kernel(occ_frac=float(occ), out_dir=tmp_path,
                               verbose=False)
    assert out["fetch"] == ref["fetch"]
    assert out["shape"] == ref["shape"]
    assert json.loads((tmp_path / name).read_text()) == out
    assert committed.read_bytes() == before
    flops = round(ref["terms_s"]["compute_s"] * TPU_PEAK_FLOPS)
    dense = round(ref["terms_s"]["memory_dense_s"] * TPU_HBM_BW)
    compact = round(ref["terms_s"]["memory_compact_s"] * TPU_HBM_BW)
    assert out["work"] == {"flops": flops, "bytes_dense": dense,
                           "bytes_compact": compact}
    assert out["terms_s"] == {
        "compute_s": flops / troof.H100_BF16_FLOPS,
        "memory_dense_s": dense / troof.H100_HBM_BW,
        "memory_compact_s": compact / troof.H100_HBM_BW}
    t = out["terms_s"]
    assert out["modeled_speedup"] == (
        max(t["memory_dense_s"], t["compute_s"])
        / max(t["memory_compact_s"], t["compute_s"]))


def test_roofline_cli_and_unported_cell_roofline(tmp_path, capsys,
                                                monkeypatch):
    troof.main(["--kernel", "--out-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and all(str(tmp_path) in x for x in lines)
    assert len(list(tmp_path.glob("sata_kernel__*.json"))) == 3
    # the per-cell roofline runs every cell (the train and prefill cells:
    # tests/test_torch_dryrun.py); a decode cell counts one token a row,
    # its probes keep the full-depth cell's weights' mode and rwkv6 adds
    # no scan term; the CLI needs a cell, --all, --table or --kernel
    monkeypatch.setattr(troof, "OUT_DIR", tmp_path / "cells")
    for arch, shape in (("qwen3-4b", "decode_32k"),
                        ("rwkv6-1.6b", "long_500k")):
        r = troof.analyse_cell(arch, shape, verbose=False)
        spec = tarchs.SHAPES[shape]
        cfg = tarchs.ARCHS[arch]
        assert r["param_mode"] == "infer_tp"
        assert r["model_flops"] == 2 * cfg.active_param_count() * \
            spec.global_batch
        assert r["per_device"]["rwkv_scan_flops"] == 0
        assert r["dominant"] == "memory"
        assert (tmp_path / "cells" / f"{arch}__{shape}__pod1.json").exists()
    with pytest.raises(SystemExit):
        troof.main([])


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_runs_on_the_cpu(capsys):
    """Steps 1-3 on the port's numpy, step 4 on the kernel's plain
    version: the oracle error is fp32 summation order."""
    _example("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "workload KVT-DeiT-Tiny" in out
    err = float(out.rsplit("oracle ", 1)[1].split()[0])
    assert err < 1e-5


def test_schedule_demo_torch_runs(capsys):
    _example("schedule_demo_torch").main()
    assert "coverage check: True" in capsys.readouterr().out
