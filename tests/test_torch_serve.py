"""Port parity for the slice as a whole: JAX parameters loaded into the
port, teacher-forced prefill → install → decode logits, and ``serve()``
at the configuration of ``examples/serve_topk.py`` (qwen3-4b smoke,
bisect, SATA decode on, 8-token blocks, exact re-plan every step).

Logits are held to atol 1e-4 (fp32 matmul and softmax summation order
accumulated over 4 layers).  ``serve()`` must give EQUAL greedy token
streams and equal fetch-tile counters.  The reference runs with
``host_swap_bytes=0``: its default preempts by host swap, a slice-3
feature of the port, while the port preempts by requeue — the
reference's other preemption mode, selected that way."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import SMOKE as JSMOKE  # noqa: E402
from repro.core.paging import PageAllocator as JAlloc  # noqa: E402
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

LOGIT_ATOL = 1e-4    # fp32 summation order over 4 layers
EXAMPLE = dict(n_requests=6, batch_slots=3, gen_len=48, max_len=64)


def _cfgs(layout="contiguous", pool_pages=0):
    out = []
    for smoke, dec, kvc in ((JSMOKE, JDec, JKV), (TSMOKE, TDec, TKV)):
        base = smoke["qwen3-4b"]
        out.append(dataclasses.replace(
            base, topk_impl="bisect",
            sata=dataclasses.replace(base.sata, decode=dec(
                mode="on", block=8, replan=1)),
            kv=kvc(layout=layout, pool_pages=pool_pages)))
    return out


@pytest.fixture(scope="module")
def weights():
    """The reference's seed-0 parameters, and the port's model built
    from them."""
    jc, tc = _cfgs()
    params = jmdl.init_params(jax.random.PRNGKey(0), jc)
    model = params_from_jax(jax.tree.map(np.asarray, params), tc,
                            device="cpu")
    return params, model


RUNS = {"contiguous": ("contiguous", 0, 1),
        "paged_pool12": ("paged", 12, 1),
        "prompt6": ("contiguous", 0, 6)}


@pytest.fixture(scope="module")
def reference_runs(weights):
    """Each JAX reference serve runs once per module (about 10 s each on
    the CPU), lazily, keyed like ``RUNS``."""
    params, _ = weights
    done = {}

    def get(name):
        if name not in done:
            layout, pool, plen = RUNS[name]
            jc, _ = _cfgs(layout, pool)
            done[name] = jsv.serve(
                "qwen3-4b", smoke=True, cfg=jc, params=params,
                options=jsv.ServeOptions(prompt_len=plen, **EXAMPLE),
                resilience=jsv.ResilienceOptions(host_swap_bytes=0))
        return done[name]
    return get


def test_params_from_jax_loads_every_leaf(weights):
    params, model = weights
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    sd = model.state_dict()
    n = 0
    for path, leaf in flat:
        keys = [p.key for p in path]
        leaf = np.asarray(leaf)
        if keys[0] == "layers":
            for i in range(leaf.shape[0]):
                name = ".".join(["layers", str(i)] + keys[1:])
                np.testing.assert_array_equal(sd[name].numpy(), leaf[i])
                n += 1
        else:
            np.testing.assert_array_equal(sd[".".join(keys)].numpy(), leaf)
            n += 1
    assert n == len(sd)
    # trainable: serving records no graph (it runs under inference_mode)
    assert all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_teacher_forced_logits_match(weights, layout):
    """prefill_prompt → install_prefill → 8 serve_steps on both sides,
    the port fed the reference's greedy tokens: logits within 1e-4 at
    every step, and identical seeded plans."""
    params, model = weights
    jc, tc = _cfgs(layout)
    b, max_len, sp, slot = 2, 64, 6, 1
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
    phys = None
    if layout == "paged":
        alloc = JAlloc(int(jcache["kv"]["k_pages"].shape[1]), b, 8, 8,
                       audit=False)
        assert alloc.ensure(slot, max_len - 1)
        jcache = jdec.set_page_table(jc, jcache, alloc.table)
        tdec.set_page_table(tc, tcache, alloc.table)
        phys = alloc.table[slot, :1]
    jcache = jdec.install_prefill(jc, jcache, slot, jst, phys)
    tdec.install_prefill(tc, tcache, slot, tst, phys)
    tok = np.zeros((b, 1), np.int32)
    pos = np.zeros(b, np.int32)
    tok[slot, 0] = int(np.argmax(np.asarray(jl0[0])))
    pos[slot] = sp
    jstep = jax.jit(lambda p, c, t, q: jdec.serve_step(p, jc, c, t, q))
    for step in range(8):
        jlg, jcache = jstep(params, jcache, jnp.asarray(tok),
                            jnp.asarray(pos))
        tlg, _ = tdec.serve_step(model, tc, tcache, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(tlg[slot].numpy(),
                                   np.asarray(jlg[slot]), atol=LOGIT_ATOL,
                                   rtol=0, err_msg=f"step {step}")
        tok[slot, 0] = int(np.argmax(np.asarray(jlg[slot, 0])))
        pos[slot] += 1


@pytest.mark.parametrize("name", list(RUNS))
def test_serve_matches_reference(weights, reference_runs, name):
    _, model = weights
    layout, pool, plen = RUNS[name]
    want = reference_runs(name)
    _, tc = _cfgs(layout, pool)
    got = tsv.serve("qwen3-4b", smoke=True, cfg=tc, model=model,
                    options=tsv.ServeOptions(prompt_len=plen, **EXAMPLE),
                    device="cpu")
    assert got["outputs"] == want["outputs"]
    assert all(len(v) == EXAMPLE["gen_len"] for v in got["outputs"].values())
    assert got["steps"] == want["steps"]
    assert got["tokens_generated"] == want["tokens_generated"]
    for k in ("kv_fetch_tiles_plan", "kv_fetch_tiles_dense",
              "plan_fetch_bytes", "replans"):
        assert got["decode_fetch"][k] == want["decode_fetch"][k], k
    assert got["decode_fetch"]["kv_fetch_tiles_plan"] < \
        got["decode_fetch"]["kv_fetch_tiles_dense"]
    if layout == "paged":
        for k in ("pages_in_use_peak", "stalled_steps", "preemptions",
                  "deferred_claims", "hbm_reserved_bytes"):
            assert got["page_occupancy"][k] == want["page_occupancy"][k], k
        assert got["page_occupancy"]["preemptions"] > 0   # path exercised


def test_serve_rejects_unported_options():
    _, tc = _cfgs()
    with pytest.raises(NotImplementedError, match="slice 3"):
        tsv.serve("qwen3-4b", cfg=tc, device="cpu", faults=object())
    with pytest.raises(NotImplementedError, match="slice 3"):
        tsv.serve("qwen3-4b", cfg=tc, device="cpu", resilience=object())
