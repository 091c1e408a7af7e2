"""Port parity for serving the hybrid and ssm families: SMOKE zamba2-2.7b
(4 Mamba2 layers, the shared block after every 2: two KV caches under
``shared_kv``) and SMOKE rwkv6-1.6b (4 layers, no KV cache), at the
serve example's settings (bisect, SATA decode on, 8-token blocks, exact
re-plan every step), fp32, the reference's weights loaded into the
port.

``serve()`` must give EQUAL greedy token streams, steps and fetch-tile
counters (zamba2 paged and contiguous, rwkv6 contiguous), under pool
pressure the same requeues and no host swap in either package (the
recurrent state is not in the pages), and a serve killed after a
checkpoint resumes to the uninterrupted run's streams in both (the
recurrent state rides the checkpoint).  Teacher-forced logits are held
to atol 1e-4 (fp32 summation order), plan fields exactly; the slot
functions equal the reference's, and ``reset_slot`` zeroes exactly the
claimed slot's recurrent state.  The QoS ladder under load spikes and
cascade retirement under pool pressure act on ``shared_kv``'s plan and
pages as on the dense family's ``kv``: reports equal, the retirement's
``head_importance`` to 1e-5 relative (the jitted reference fuses its
decayed update into an FMA, ROADMAP C6)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.launch import serve as jsv  # noqa: E402
from repro.launch.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models.config import KVCacheConfig as JKV  # noqa: E402
from repro.models.config import SataDecodeConfig as JDec  # noqa: E402
from repro_torch.configs.archs import SMOKE as TSMOKE  # noqa: E402
from repro_torch.launch import serve as tsv  # noqa: E402
from repro_torch.launch.faults import FaultPlan as TFaultPlan  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models.config import KVCacheConfig as TKV  # noqa: E402
from repro_torch.models.config import SataDecodeConfig as TDec  # noqa: E402
from repro_torch.models.model import params_from_jax  # noqa: E402

LOGIT_ATOL = 1e-4
HEAD_IMP_RTOL = 1e-5
HYBRID, SSM = "zamba2-2.7b", "rwkv6-1.6b"
EXAMPLE = dict(n_requests=6, batch_slots=3, gen_len=24, max_len=64)
STATE = {HYBRID: "mamba", SSM: "rwkv"}


def _cfgs(arch, layout="contiguous", sata=None, **kv):
    """(JAX, port) configs; ``sata`` overrides sub-configs of
    ``cfg.sata`` by name ({"qos": {"ladder": True}})."""
    out = []
    for smoke, dec, kvc in ((JSMOKE, JDec, JKV), (TSMOKE, TDec, TKV)):
        base = smoke[arch]
        sc = dataclasses.replace(base.sata, decode=dec(
            mode="on", block=8, replan=1))
        for name, kw in (sata or {}).items():
            sc = dataclasses.replace(sc, **{name: dataclasses.replace(
                getattr(sc, name), **kw)})
        out.append(dataclasses.replace(base, topk_impl="bisect", sata=sc,
                                       kv=kvc(layout=layout, **kv)))
    return out


_WEIGHTS = {}


def _weights(arch):
    """The reference's seed-0 parameters and the port's model built from
    them, once per architecture."""
    if arch not in _WEIGHTS:
        jc, tc = _cfgs(arch)
        params = jmdl.init_params(jax.random.PRNGKey(0), jc)
        _WEIGHTS[arch] = (params, params_from_jax(
            jax.tree.map(np.asarray, params), tc, device="cpu"))
    return _WEIGHTS[arch]


def _serve(arch, pkg, layout, kv=None, opts=None, sata=None, faults=None,
           **res):
    params, model = _weights(arch)
    jc, tc = _cfgs(arch, layout, sata, **(kv or {}))
    o = {**EXAMPLE, **(opts or {})}
    if pkg == "jax":
        return jsv.serve(arch, smoke=True, cfg=jc, params=params,
                         options=jsv.ServeOptions(**o),
                         faults=faults(JFaultPlan()) if faults else None,
                         resilience=jsv.ResilienceOptions(**res))
    return tsv.serve(arch, smoke=True, cfg=tc, model=model,
                     options=tsv.ServeOptions(**o),
                     faults=faults(TFaultPlan()) if faults else None,
                     resilience=tsv.ResilienceOptions(**res), device="cpu")


FETCH_KEYS = ("kv_fetch_tiles_plan", "kv_fetch_tiles_dense",
              "plan_fetch_bytes", "replans")
OCC_KEYS = ("pages_in_use_peak", "stalled_steps", "preemptions",
            "deferred_claims", "host_swaps", "requeue_preemptions",
            "requeue_tokens_discarded", "hbm_reserved_bytes")


def _check(want, got, gen_len):
    assert got["outputs"] == want["outputs"]
    assert all(len(v) == gen_len for v in got["outputs"].values())
    assert got["steps"] == want["steps"]
    assert got["tokens_generated"] == want["tokens_generated"]
    assert ("decode_fetch" in got) == ("decode_fetch" in want)
    for k in FETCH_KEYS if "decode_fetch" in want else ():
        assert got["decode_fetch"][k] == want["decode_fetch"][k], k
    assert ("page_occupancy" in got) == ("page_occupancy" in want)
    for k in OCC_KEYS if "page_occupancy" in want else ():
        assert got["page_occupancy"][k] == want["page_occupancy"][k], k


RUNS = {  # name: (arch, layout, kv overrides, options)
    "zamba2_paged": (HYBRID, "paged", {}, {}),
    "zamba2_contiguous": (HYBRID, "contiguous", {}, {}),
    "rwkv6_contiguous": (SSM, "contiguous", {}, {}),
    # 10 usable pages for 3 slots that each grow to 5: stalls, then
    # preemption — requeue, since neither package swaps recurrent state
    "zamba2_pool_pressure": (HYBRID, "paged", {"pool_pages": 11},
                             {"gen_len": 40}),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_serve_matches_reference(name):
    """Equal greedy streams, steps and fetch counters; on the paged
    layout equal page occupancy and preemption counters."""
    arch, layout, kv, extra = RUNS[name]
    want = _serve(arch, "jax", layout, kv, extra)
    got = _serve(arch, "torch", layout, kv, extra)
    _check(want, got, extra.get("gen_len", EXAMPLE["gen_len"]))
    if arch == HYBRID:
        assert got["decode_fetch"]["kv_fetch_tiles_plan"] > 0
    else:
        assert "decode_fetch" not in got      # no attention, no plan
    if name == "zamba2_pool_pressure":
        occ = got["page_occupancy"]
        assert occ["requeue_preemptions"] > 0 and occ["host_swaps"] == 0


OVERLOAD = {  # name: (kv overrides, options, sata overrides, faults)
    "ladder_spikes": ({}, {}, {"qos": {"ladder": True}},
                      lambda fp: fp.load_spike(4, 2).slow_step(5)
                      .load_spike(10, 1)),
    # 11 usable pages for 3 slots that each grow to 5
    "retire_pressure": ({"pool_pages": 12}, {"gen_len": 40},
                        {"retire": {"mode": "on", "keep": 0.5,
                                    "watermark": 0.4}}, None),
}


@pytest.mark.parametrize("name", list(OVERLOAD))
def test_overload_serve_matches_reference(name):
    """zamba2 paged under the QoS ladder with load spikes (rungs pressed
    on ``shared_kv``'s plan knobs) and with cascade retirement on a
    short pool (blocks retired from ``shared_kv``'s plan and pages):
    the whole report equals the reference's."""
    kv, opts, sata, faults = OVERLOAD[name]
    want = _serve(HYBRID, "jax", "paged", kv, opts, sata, faults)
    got = _serve(HYBRID, "torch", "paged", kv, opts, sata, faults)
    _check(want, got, opts.get("gen_len", EXAMPLE["gen_len"]))
    for k in ("degradation", "qos", "timed_out"):
        assert got.get(k) == want.get(k), k
    assert got["decode_fetch"] == want["decode_fetch"]
    for k, v in want["page_occupancy"].items():
        if k != "swap_restore_wall_s":
            assert got["page_occupancy"][k] == v, k
    if name == "ladder_spikes":
        assert got["qos"]["rung_downs"] > 0
    else:
        w, g = dict(want["retirement"]), dict(got["retirement"])
        np.testing.assert_allclose(g.pop("head_importance"),
                                   w.pop("head_importance"),
                                   rtol=HEAD_IMP_RTOL)
        assert g == w and g["pages_reclaimed"] > 0


def test_paged_and_contiguous_streams_agree():
    """zamba2's shared block decodes bitwise alike on both layouts."""
    got = {layout: _serve(HYBRID, "torch", layout)["outputs"]
           for layout in ("paged", "contiguous")}
    assert got["paged"] == got["contiguous"]


@pytest.mark.parametrize("arch,layout", [(HYBRID, "paged"),
                                         (SSM, "contiguous")])
def test_checkpoint_kill_resume_matches_reference(arch, layout, tmp_path):
    """Kill the loop at step 7 after a save at step 5, then resume from
    disk: both packages resume at step 5 and serve the uninterrupted
    run's streams (the mamba / rwkv state is saved with the cache)."""
    runs = {}
    for pkg in ("jax", "torch"):
        d = str(tmp_path / pkg)
        with pytest.raises((jsv if pkg == "jax" else tsv).ServeKilled):
            _serve(arch, pkg, layout, checkpoint_dir=d, checkpoint_every=5,
                   kill_at_step=7)
        runs[pkg] = _serve(arch, pkg, layout, checkpoint_dir=d,
                           checkpoint_every=5, resume=True)
    want, got = runs["jax"], runs["torch"]
    assert got["checkpoint"]["resumed_at"] == \
        want["checkpoint"]["resumed_at"] == 5
    _check(want, got, EXAMPLE["gen_len"])
    assert got["outputs"] == _serve(arch, "torch", layout)["outputs"]


def test_paged_ssm_is_refused():
    """rwkv6 has no KV cache to page: the port names the cause where the
    reference fails on the missing pool."""
    with pytest.raises(TypeError):
        _serve(SSM, "jax", "paged")
    with pytest.raises(ValueError, match="has none"):
        _serve(SSM, "torch", "paged")


def _stepped(arch, b=3, steps=6):
    """``init_cache`` → ``steps`` teacher-forced ``serve_step``s at
    per-slot positions in both packages (the port fed the reference's
    greedy tokens); logits held to 1e-4 at every step.

    The reference steps eagerly (``jax.disable_jit()``): the port
    mirrors its eager arithmetic, op by op, while under ``jit`` XLA
    fuses and reorders fp32 sums.  SMOKE rwkv6's layer-3 group norm
    divides a head of variance 1.05e-4, which turns that reordering
    alone into 3.7e-5 of logit (eager vs jitted reference), so the
    jitted reference would hold the port to a summation order rather
    than to the function (ROADMAP C, closed)."""
    params, model = _weights(arch)
    jc, tc = _cfgs(arch)
    jcache = jdec.init_cache(jc, b, 64)
    tcache = tdec.init_cache(tc, b, 64, device="cpu")
    tok = np.array([[5], [17], [200]], np.int32)
    pos = np.array([0, 3, 9], np.int32)
    for _ in range(steps):
        with jax.disable_jit():
            jlg, jcache = jdec.serve_step(params, jc, jcache,
                                          jnp.asarray(tok), jnp.asarray(pos))
        tlg, tcache = tdec.serve_step(model, tc, tcache,
                                      torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg),
                                   atol=LOGIT_ATOL, rtol=0)
        tok = np.argmax(np.asarray(jlg)[:, 0], axis=-1)[:, None].astype(
            np.int32)
        pos = pos + 1
    return jc, tc, jcache, tcache


@pytest.mark.parametrize("arch", [HYBRID, SSM])
def test_teacher_forced_steps_and_slot_functions_match(arch):
    """Six steps: logits within 1e-4, the recurrent state within 1e-4,
    zamba2's plan fields over ``shared_kv`` exactly; then
    ``capture_plan_state``, ``reset_slot`` and ``release_slot`` equal
    the reference's, and ``reset_slot`` zeroes exactly the claimed
    slot's recurrent state, leaving the other slots' bits alone."""
    jc, tc, jcache, tcache = _stepped(arch)
    name = STATE[arch]
    for k, t in tcache[name].items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jcache[name][k]),
                                   atol=LOGIT_ATOL, rtol=0, err_msg=k)
    if arch == HYBRID:
        for f in ("kv_indices", "kv_counts", "step", "replans"):
            np.testing.assert_array_equal(
                tcache["shared_kv"]["plan"][f].numpy(),
                np.asarray(jcache["shared_kv"]["plan"][f]), err_msg=f)
        for slot in (1, 2):
            want = jdec.capture_plan_state(jc, jcache, slot)
            got = tdec.capture_plan_state(tc, tcache, slot)
            assert sorted(got) == sorted(want) == ["shared_kv"]
            for f in ("kv_indices", "kv_counts", "step", "replans"):
                np.testing.assert_array_equal(
                    got["shared_kv"][f], np.asarray(want["shared_kv"][f]),
                    err_msg=f)
    else:
        assert tdec.capture_plan_state(tc, tcache, 1) == {} == \
            jdec.capture_plan_state(jc, jcache, 1)
    before = {k: t.clone() for k, t in tcache[name].items()}
    assert all(float(t[:, 1].abs().max()) > 0 for t in before.values())
    jcache = jdec.release_slot(jc, jdec.reset_slot(jc, jcache, 1), 2)
    tdec.release_slot(tc, tdec.reset_slot(tc, tcache, 1), 2)
    for k, t in tcache[name].items():
        assert not t[:, 1].any(), k
        for s in (0, 2):
            assert torch.equal(t[:, s], before[k][:, s]), (k, s)
        np.testing.assert_array_equal(t[:, 1].numpy(),
                                      np.asarray(jcache[name][k])[:, 1])
    if arch == HYBRID:
        for f, t in tcache["shared_kv"]["plan"].items():
            a = np.asarray(jcache["shared_kv"]["plan"][f])
            if t.dtype.is_floating_point:
                np.testing.assert_allclose(t.numpy(), a, atol=LOGIT_ATOL,
                                           rtol=0, err_msg=f)
            else:
                np.testing.assert_array_equal(t.numpy(), a, err_msg=f)
