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
import torch_threads  # noqa: E402,F401  (one intra-op thread)
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


# ---------------------------------------------------------------------------
# the rest of the dense family (olmo-1b's non-parametric norm, layernorm)
# and the moe family, through the whole model
# ---------------------------------------------------------------------------

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4      # fp32 summation order over 4 layers


def _family_cfgs(arch, **kw):
    """SMOKE ``arch`` on both sides (4 layers, d_model 64, fp32)."""
    return [dataclasses.replace(s[arch], **kw) for s in (JSMOKE, TSMOKE)]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _batch(seed, b=2, s=16, vocab=256):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:],
            "loss_mask": np.ones((b, s), np.float32)}


def _grads_by_path(params, jg, model):
    """[(path, JAX grad, port grad)] over every reference leaf."""
    out = []
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        keys = [p.key for p in path]
        if keys[0] == "layers":
            tg = torch.stack([model.layers[i][keys[1]][keys[2]].grad
                              for i in range(len(model.layers))])
        else:
            tg = model[keys[0]][keys[1]].grad
        out.append((tuple(keys), np.asarray(g), tg))
    return out


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm",
                                       "nonparam_ln"])
def test_norm_params_and_apply_for_every_norm_type(norm_type):
    """``Norm`` holds the reference's ``norm_init`` leaves (none for
    nonparam_ln) and ``apply_norm`` matches with non-trivial scale and
    bias; ``params_from_jax`` loads a model of each type."""
    from repro.models import model as jmdl
    from repro_torch.models.model import Norm, _Init, params_from_jax
    jc, tc = _family_cfgs("qwen3-4b", norm_type=norm_type)
    want = jl.norm_init(jc, 64)
    norm = Norm(tc, _Init(tc, torch.device("cpu"), None))
    assert sorted(n for n, _ in norm.named_parameters()) == sorted(want)
    x = _rand(50, 2, 5, 64)
    p = {n: 1.0 + 0.1 * _rand(51 + i, 64) for i, n in enumerate(want)}
    _close(tl.apply_norm({n: torch.from_numpy(a) for n, a in p.items()},
                         tc, torch.from_numpy(x)),
           jl.apply_norm({n: jnp.asarray(a) for n, a in p.items()}, jc,
                         jnp.asarray(x)), ELEM_ATOL)
    params = jmdl.init_params(jax.random.PRNGKey(0), jc)
    model = params_from_jax(_np_tree(params), tc, device="cpu")
    n_leaves = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        if keys[0] == "layers":
            got = torch.stack([model.layers[i][keys[1]][keys[2]]
                               for i in range(tc.n_layers)])
        else:
            got = model[keys[0]][keys[1]]
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(leaf))
        n_leaves += tc.n_layers if keys[0] == "layers" else 1
    assert n_leaves == len(model.state_dict())


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-235b-a22b"])
def test_family_forward_loss_and_grads_match(arch):
    """``forward`` / ``loss_fn`` of SMOKE olmo-1b (nonparam_ln) and SMOKE
    qwen3-moe (the MoE FFN in every layer, its aux loss summed over the
    layers and added at 0.01) against the reference: logits, loss, the
    parts, and every parameter's gradient."""
    from repro.models import model as jmdl
    from repro_torch.models import model as tmdl
    jc, tc = _family_cfgs(arch)
    params = jmdl.init_params(jax.random.PRNGKey(1), jc)
    model = tmdl.params_from_jax(_np_tree(params), tc, device="cpu")
    batch = _batch(7)
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    jlogits, jaux = jmdl.forward(params, jc, batch)
    tlogits, taux = tmdl.forward(model, tc, tb)
    _close(tlogits, jlogits, 1e-4)
    (jl_, jparts), jg = jax.value_and_grad(
        lambda p: jmdl.loss_fn(p, jc, batch), has_aux=True)(params)
    tl_, tparts = tmdl.loss_fn(model, tc, tb)
    tl_.backward()
    np.testing.assert_allclose(tl_.item(), float(jl_), rtol=LOSS_RTOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(tparts[k].item(), float(jparts[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    if arch == "olmo-1b":
        assert taux.item() == 0.0 and not any(
            n.startswith("layers.0.ln") for n in model.state_dict())
    else:
        assert taux.item() > 0 and np.isclose(taux.item(), float(jaux),
                                              rtol=LOSS_RTOL)
    for path, g, tg in _grads_by_path(params, jg, model):
        np.testing.assert_allclose(tg.numpy(), g, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=str(path))


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-235b-a22b"])
def test_remat_dots_equals_none_and_the_reference(arch):
    """``remat="dots"`` saves the outputs of the no-batch-dim products and
    recomputes the rest in the backward: on the CPU the recompute runs
    the same ops at the same shapes, so loss and gradients equal
    ``"none"``'s bitwise, and the reference's ``"dots"`` within the fp32
    tolerances."""
    from repro.models import model as jmdl
    from repro_torch.models import model as tmdl
    jc, _ = _family_cfgs(arch, remat="dots")
    params = jmdl.init_params(jax.random.PRNGKey(2), jc)
    batch = _batch(8)
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    runs = {}
    for remat in ("none", "dots"):
        _, tc = _family_cfgs(arch, remat=remat)
        model = tmdl.params_from_jax(_np_tree(params), tc, device="cpu")
        loss, _ = tmdl.loss_fn(model, tc, tb)
        loss.backward()
        runs[remat] = (loss.detach(), {n: p.grad for n, p in
                                       model.named_parameters()}, model)
    assert torch.equal(runs["none"][0], runs["dots"][0])
    for n, g in runs["none"][1].items():
        assert torch.equal(g, runs["dots"][1][n]), n
    (jl_, _), jg = jax.value_and_grad(
        lambda p: jmdl.loss_fn(p, jc, batch), has_aux=True)(params)
    np.testing.assert_allclose(runs["dots"][0].item(), float(jl_),
                               rtol=LOSS_RTOL)
    for path, g, tg in _grads_by_path(params, jg, runs["dots"][2]):
        np.testing.assert_allclose(tg.numpy(), g, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=str(path))


def test_remat_dots_saves_only_the_unbatched_products():
    """Under ``"dots"`` the backward recomputes a layer but replays the
    projections' and MLP's mm outputs from the forward: counting the
    aten.mm calls run while the backward recomputes shows none."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models import model as tmdl

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    tb = {k: torch.from_numpy(a) for k, a in _batch(9).items()}
    counts = {}
    for remat in ("full", "dots"):
        _, tc = _family_cfgs("qwen3-4b", remat=remat)
        model = tmdl.DenseModel(tc, device="cpu", seed=0)
        loss, _ = tmdl.loss_fn(model, tc, tb)
        with Count() as c:
            loss.backward()
        counts[remat] = c.n
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    # "full" recomputes every projection of every layer; "dots" none, so
    # its backward runs fewer mm calls (the gradient products only)
    assert counts["dots"].get(mm, 0) < counts["full"].get(mm, 0)
    assert counts["dots"].get(bmm, 0) == counts["full"].get(bmm, 0) > 0
