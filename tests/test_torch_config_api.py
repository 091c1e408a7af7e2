"""Port parity for the deprecated flat spellings, the serve CLI and the
new examples: ``ModelConfig``'s flat-knob shims (constructor kwargs,
``dataclasses.replace``, attribute reads, one warning per name), the
legacy flat ``serve()`` kwargs, and ``python -m repro_torch.launch.serve
--replicas 2`` — each held to the reference on the same inputs (the
cases of ``tests/test_config_api.py`` that apply to the port) — plus
``examples/serve_topk_torch.py --replicas 2`` run on the CPU and
``examples/train_lm_torch.py``'s model against the reference example's.

The warn-once registries are process-global and several test files
share a worker, so every test starts from fresh ones."""
import dataclasses
import importlib.util
import os
import pathlib
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.launch import serve as jsv  # noqa: E402
from repro.models import config as jconf  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.launch import serve as tsv  # noqa: E402
from repro_torch.models import config as tconf  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {"reference": jconf, "port": tconf}


@pytest.fixture(autouse=True)
def _fresh_warn_registries(monkeypatch):
    for mod in (jconf, tconf):
        monkeypatch.setattr(mod, "_warned_flat", set())
    for mod in (jsv, tsv):
        monkeypatch.setattr(mod, "_warned_serve_legacy", False)


def _cfg(conf, **kw):
    return conf.ModelConfig(name="t", family="dense", n_layers=1, d_model=32,
                            n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                            attention_variant="topk", topk_k=8, **kw)


def _deprecations(w):
    return [x for x in w if issubclass(x.category, DeprecationWarning)]


FLAT = dict(sata_block=64, sata_decode="on", sata_decode_block=8,
            kv_cache_layout="paged", kv_page_size=8, kv_prefix_cache=True,
            sata_qos_ladder=True, sata_retire="on")


# ---------------------------------------------------------------------------
# flat <-> nested
# ---------------------------------------------------------------------------

def test_flat_map_is_the_reference_map():
    assert tconf._FLAT_MAP == jconf._FLAT_MAP


def test_flat_kwargs_fold_into_nested_groups():
    """Flat constructor kwargs equal the nested spelling, and fold into
    the reference's nested values field for field."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        flat = {k: _cfg(c, **FLAT) for k, c in PKGS.items()}
    c = tconf
    nested = _cfg(c, sata=c.SataConfig(
        kernel=c.SataKernelConfig(block=64),
        decode=c.SataDecodeConfig(mode="on", block=8),
        qos=c.QosConfig(ladder=True), retire=c.RetireConfig(mode="on")),
        kv=c.KVCacheConfig(layout="paged", page_size=8, prefix_cache=True))
    assert flat["port"] == nested
    assert flat["port"].sata.kernel.block == 64
    assert dataclasses.asdict(flat["port"]) == \
        dataclasses.asdict(flat["reference"])


def test_flat_properties_read_nested_values():
    for conf in PKGS.values():
        cfg = _cfg(conf, sata=conf.SataConfig(
            decode=conf.SataDecodeConfig(mode="on", replan=4)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            assert cfg.sata_decode == "on"
            assert cfg.sata_decode_replan == 4
            assert cfg.kv_cache_layout == "contiguous"


def test_replace_accepts_flat_and_nested_keys():
    got = {}
    for k, c in PKGS.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            c1 = dataclasses.replace(_cfg(c), sata_decode="on",
                                     kv_pool_pages=7)
        c2 = dataclasses.replace(
            _cfg(c), sata=dataclasses.replace(
                _cfg(c).sata, decode=c.SataDecodeConfig(mode="on")),
            kv=c.KVCacheConfig(pool_pages=7))
        assert c1 == c2
        got[k] = dataclasses.asdict(c1)
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("flat", sorted(jconf._FLAT_MAP))
def test_every_flat_name_reads_and_replaces_like_the_reference(flat):
    """Each flat name reads its nested value, and ``replace`` with it
    moves the same nested field in both packages."""
    vals = {}
    for k, c in PKGS.items():
        cfg = _cfg(c)
        node = cfg
        for part in c._FLAT_MAP[flat]:
            node = getattr(node, part)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            assert getattr(cfg, flat) == node, flat
            # a value of the field's type that differs from the default
            new = {bool: not node, int: 3, float: 0.5, str: node,
                   type(None): 5}[type(node)]
            vals[k] = dataclasses.asdict(dataclasses.replace(
                cfg, **{flat: new}))
    assert vals["port"] == vals["reference"]


# ---------------------------------------------------------------------------
# deprecation warnings: once per flat name per process
# ---------------------------------------------------------------------------

def test_flat_read_warns_exactly_once():
    msgs = {}
    for k, c in PKGS.items():
        cfg = _cfg(c)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            cfg.sata_block
            cfg.sata_block
            cfg.sata_block
        dep = _deprecations(w)
        assert len(dep) == 1
        assert "sata.kernel.block" in str(dep[0].message)
        msgs[k] = str(dep[0].message)
    assert msgs["port"] == msgs["reference"]


def test_flat_constructor_kwarg_warns_once():
    for c in PKGS.values():
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            _cfg(c, sata_decode="on")
            _cfg(c, sata_decode="on")
        assert len(_deprecations(w)) == 1


def test_nested_access_never_warns():
    cfg = _cfg(tconf)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg.sata.kernel.block
        cfg.sata.decode.mode
        cfg.kv.layout
        dataclasses.replace(cfg, topk_k=4)
    assert not _deprecations(w)


# ---------------------------------------------------------------------------
# construction-time validation, serialization
# ---------------------------------------------------------------------------

def test_paged_page_block_mismatch_raises_at_construction():
    """Through the flat spelling too, in both packages."""
    for c in PKGS.values():
        with pytest.raises(ValueError, match="page_size == the decode"):
            _cfg(c, sata=c.SataConfig(decode=c.SataDecodeConfig(
                mode="on", block=4)),
                 kv=c.KVCacheConfig(layout="paged", page_size=8))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(ValueError, match="page_size == the decode"):
                _cfg(c, sata_decode="on", sata_decode_block=4,
                     kv_cache_layout="paged", kv_page_size=8)


def test_paged_matching_page_block_constructs():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cfg = _cfg(tconf, sata_decode="on", sata_decode_block=8,
                   kv_cache_layout="paged", kv_page_size=8)
    assert cfg.kv.page_size == cfg.sata.decode.block == 8


def test_kv_layout_validated():
    for c in PKGS.values():
        with pytest.raises(ValueError, match="layout"):
            c.KVCacheConfig(layout="interleaved")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(ValueError, match="layout"):
                _cfg(c, kv_cache_layout="interleaved")


def test_nested_config_checkpoint_meta_roundtrip(tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    c = tconf
    cfg = _cfg(c, sata=c.SataConfig(
        kernel=c.SataKernelConfig(block=64),
        decode=c.SataDecodeConfig(mode="on", block=8, replan=2)),
        kv=c.KVCacheConfig(layout="paged", page_size=8, prefix_cache=True))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(0, {"x": torch.zeros(2)}, blocking=True,
             meta_blob=pickle.dumps({"cfg": cfg, "step": 0}))
    meta = pickle.loads(mgr.load_meta(0))
    assert meta["cfg"] == cfg and hash(meta["cfg"]) == hash(cfg)
    assert meta["cfg"].sata.decode.replan == 2


def test_pickle_roundtrip_plain():
    c = tconf
    cfg = _cfg(c, sata=c.SataConfig(decode=c.SataDecodeConfig(
        summary="int8")))
    assert pickle.loads(pickle.dumps(cfg)) == cfg


# ---------------------------------------------------------------------------
# the legacy flat serve() kwargs
# ---------------------------------------------------------------------------

def test_serve_legacy_kwargs_fold():
    legacy = {"n_requests": 3, "gen_len": 5, "audit_pages": False,
              "checkpoint_every": 2}
    got = [dataclasses.asdict(x) for x in
           tsv._fold_serve_legacy(None, None, dict(legacy))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = [dataclasses.asdict(x) for x in
                jsv._fold_serve_legacy(None, None, dict(legacy))]
    assert got == want
    assert got[0]["n_requests"] == 3 and got[1]["audit_pages"] is False
    assert tsv._LEGACY_SERVE_KW == jsv._LEGACY_SERVE_KW


def test_serve_legacy_overrides_options_base():
    base = tsv.ServeOptions(n_requests=9, batch_slots=2)
    res = tsv.ResilienceOptions(checkpoint_every=4, resume=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        opt, r = tsv._fold_serve_legacy(base, res, {"n_requests": 3,
                                                    "resume": False})
    assert opt.n_requests == 3 and opt.batch_slots == 2
    assert r.checkpoint_every == 4 and r.resume is False


def test_serve_unknown_kwarg_raises():
    for sv in (jsv, tsv):
        with pytest.raises(TypeError, match="bogus"):
            sv._fold_serve_legacy(None, None, {"bogus": 1})
    with pytest.raises(TypeError, match="bogus"):
        tsv.serve("qwen3-4b", device="cpu", bogus=1)


def test_serve_legacy_warns_once_per_process():
    msgs = {}
    for k, sv in (("reference", jsv), ("port", tsv)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            sv._fold_serve_legacy(None, None, {"gen_len": 2, "max_len": 8})
            sv._fold_serve_legacy(None, None, {"gen_len": 3})
        dep = _deprecations(w)
        assert len(dep) == 1
        msgs[k] = str(dep[0].message)
    assert msgs["port"] == msgs["reference"]


def test_serve_with_legacy_kwargs_matches_reference():
    """``serve(n_requests=..., gen_len=...)`` in both packages on the same
    weights: one warning each, equal streams, and the port's own
    ``model`` / ``device`` never pass through the fold."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jc, tc = (dataclasses.replace(smoke["qwen3-4b"], topk_impl="bisect",
                                      sata_decode="on", sata_decode_block=8)
                  for smoke in (JSMOKE, TSMOKE))
    params = jmdl.init_params(jax.random.PRNGKey(0), jc)
    model = params_from_jax(jax.tree.map(np.asarray, params), tc,
                            device="cpu")
    legacy = dict(n_requests=3, batch_slots=2, gen_len=4, max_len=32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        want = jsv.serve("qwen3-4b", cfg=jc, params=params, **legacy)
        got = tsv.serve("qwen3-4b", cfg=tc, model=model, device="cpu",
                        **legacy)
    assert [str(x.message).startswith("flat serve() kwargs")
            for x in _deprecations(w)].count(True) == 2
    assert got["outputs"] == want["outputs"]
    assert got["steps"] == want["steps"]
    plain = tsv.serve("qwen3-4b", cfg=tc, model=model, device="cpu",
                      options=tsv.ServeOptions(**legacy))
    assert plain["outputs"] == got["outputs"]


# ---------------------------------------------------------------------------
# the serve CLI and the examples
# ---------------------------------------------------------------------------

CLI = ["--replicas", "2", "--requests", "4", "--slots", "2", "--gen-len",
       "3", "--prompt-len", "20", "--shared-prefix-len", "16"]


def test_cli_replicas_prints_the_reference_counts(monkeypatch, capsys):
    """The same argv through both packages' ``main``: the replicas line
    holds only counts (no weights reach it), so it is equal.  (At the
    CLI's max_len 64 a page is 64 tokens, so no prompt has a full page
    to publish, and a slot's prefix page stalls the 3-page pool: each
    replica completes 2 requests before the step cap, in both.)"""
    monkeypatch.setattr(sys, "argv", ["serve"] + CLI)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jsv.main()
    want = capsys.readouterr().out
    tsv.main(CLI + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert "[serve] 2 replicas" in want and "outputs_equal=True" in want
    assert got == want


def _run(args, timeout):
    # one intra-op thread in the child too (tests/torch_threads.py)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-W", "error::DeprecationWarning"]
                          + args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_serve_topk_torch_replicas_example():
    """The example's replica scenario self-asserts (bitwise equal
    replicas, a migration of the shared prefix) and runs clean with
    DeprecationWarnings as errors."""
    res = _run([str(ROOT / "examples" / "serve_topk_torch.py"),
                "--replicas", "2", "--device", "cpu"], 120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "outputs bitwise equal across replicas: True" in res.stdout
    assert "cross-replica hit rate" in res.stdout


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dense", [False, True])
def test_train_lm_torch_trains_the_reference_model(dense):
    """The example trains the reference example's ~100M-param config
    (its run, 162M parameters, is a card run: it checkpoints ~2 GB of
    weights and moments)."""
    want = dataclasses.asdict(_example("train_lm").lm100m(dense))
    assert dataclasses.asdict(_example("train_lm_torch").lm100m(dense)) \
        == want
