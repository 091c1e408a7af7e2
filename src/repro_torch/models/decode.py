"""Serving path, every family — port of ``repro.models.decode``: cache
init, slot reset/release, page-table pushes, the prompt prefill →
decode handoff (dense and moe), the cross-attention context
(``prefill_context``: vlm's image embeddings, audio's encoder output)
and the single-token ``serve_step``.  hybrid (zamba2) keeps each mamba
layer's recurrent state under ``mamba`` and one KV cache per
application of its shared block under ``shared_kv``; ssm (rwkv6) keeps
only its recurrent state, under ``rwkv``.  The functions on pages and
plans act on the cache's one self-attention group, ``kv`` or
``shared_kv`` (``kv_group``).

The serving cache stacks every field over layers (``(L, ...)``, as the
reference's scanned cache does; vlm's self-attention cache is one flat
stack over its n_self layers, where the reference nests it as (n_cross,
per_group), so every slot function takes batch axis 1); each layer's
decode step gets a dict of views into it and updates them in place, so
a step never copies the cache.  Host-side bookkeeping (slot claim, allocation) stays in
``launch/serve.py``.  The shared-prefix cache's device side lives here
too: the copy-on-write page copy (``copy_phys_pages``), the gather of a
matched prefix (``gather_prefix_kv``), the continuation prefill over it
and the install that seeds the matched blocks' plan summaries from the
per-page summary cache.  Host-swap preemption moves physical pages'
rows to host numpy and back (``gather_phys_pages`` /
``scatter_phys_pages``) and a slot's plan state with them
(``capture_plan_state`` / ``restore_plan_state``).  The QoS ladder
pushes its per-slot knobs (``set_qos_knobs``), and a retirement pass
scrubs the freed pages (``retire_phys_pages``) and repairs the slot's
plan (``retire_plan``).  Serving never
trains: the model's parameters are trainable, and these functions run
without autograd.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.decode_plan import (capture_plan_slot,
                                          install_plan_slot,
                                          plan_from_prefill,
                                          release_plan_slot, reset_plan_slot,
                                          retire_plan_blocks)
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_dtype, apply_norm, apply_rope,
                                       embed_apply, mlp_apply, unembed_apply)
from repro_torch.models.mamba2 import init_mamba_cache, mamba2_decode
from repro_torch.models.model import _check_family, _run_encoder, vlm_groups
from repro_torch.models.moe import moe_apply
from repro_torch.models.rwkv6 import (init_rwkv_cache, rwkv6_channel_mix,
                                      rwkv6_time_mix)

_SEED_FIELDS = ("k_min", "k_max", "k_scale", "k_zero", "kv_indices",
                "kv_counts", "step", "churn")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict[str, Any]:
    """Layer-stacked (L, ...) serving cache: ``{"kv": {...}}`` holding
    contiguous ``k``/``v`` or the paged pool + ``page_table``, and the
    SATA decode ``plan`` when routing is on (``attn.init_kv_cache``),
    with the QoS knobs under ``sata.qos.ladder`` and the retirement
    state under ``sata.retire.mode == "on"``.  vlm stacks the
    self-attention cache over its n_self layers and adds ``cross_kv``
    {"k", "v"} (n_cross, B, n_image_tokens, KV, hd); audio adds
    ``cross_kv`` (n_layers, B, encoder_len, KV, hd).  hybrid holds
    ``mamba`` {"ssm", "conv"} stacked over its n_layers and the
    self-attention cache under ``shared_kv``, stacked over the shared
    block's n_layers // hybrid_period applications; ssm holds ``rwkv``
    {"state", "tm_x", "cm_x"} stacked over its layers and no KV cache,
    in either layout.  vlm refuses the paged layout, as the reference
    does."""
    _check_family(cfg)
    if attn.paged_kv_on(cfg) and cfg.family == "vlm":
        raise NotImplementedError(
            "paged KV serving does not cover the vlm family's nested "
            "(n_cross, n_inner) cache grouping yet — use "
            "kv_cache_layout='contiguous'")
    dev = resolve_device(device)
    dt = _dtype(cfg)

    def stacked(n, one):
        return {k: t.expand(n, *t.shape).clone() for k, t in one.items()}

    if cfg.family == "ssm":
        return {"rwkv": stacked(cfg.n_layers, init_rwkv_cache(
            cfg, batch, dt, device=dev))}
    one = attn.init_kv_cache(cfg, batch, max_len, dt, device=dev)
    n_kv, n_ctx, s_ctx = cfg.n_layers, 0, 0
    if cfg.family == "hybrid":
        n_kv = cfg.n_layers // cfg.hybrid_period
    elif cfg.family == "vlm":
        n_ctx, per_group = vlm_groups(cfg)
        n_kv, s_ctx = n_ctx * per_group, cfg.n_image_tokens
    elif cfg.family == "audio":
        n_ctx, s_ctx = cfg.n_layers, cfg.encoder_len

    def stack(t):
        return t.expand(n_kv, *t.shape).clone()

    kv = {k: ({n: stack(t) for n, t in v.items()} if isinstance(v, dict)
              else stack(v)) for k, v in one.items()}
    if cfg.family == "hybrid":
        # one KV cache per application of the shared block: the weights
        # are shared, the attention histories are not
        return {"mamba": stacked(cfg.n_layers, init_mamba_cache(
            cfg, batch, dt, device=dev)), "shared_kv": kv}
    cache = {"kv": kv}
    if n_ctx:
        shape = (n_ctx, batch, s_ctx, cfg.n_kv_heads, cfg.hd)
        cache["cross_kv"] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                             "v": torch.zeros(shape, dtype=dt, device=dev)}
    return cache


def kv_group(cache: Dict) -> Optional[str]:
    """The name of the cache's self-attention group: ``"kv"``, hybrid's
    ``"shared_kv"``, or None (ssm has none)."""
    for name in ("kv", "shared_kv"):
        if name in cache:
            return name
    return None


def _kv(cache: Dict) -> Dict:
    name = kv_group(cache)
    return {} if name is None else cache[name]


def _context_valid(batch: Dict, s_ctx: int, n_layers: int, device
                   ) -> Optional[torch.Tensor]:
    """The optional per-request context-length mask: ``context_lengths``
    (B,) in the batch marks how many of the padded ``s_ctx`` positions
    are real.  Returns (L, B, S_ctx) bool, or None without lengths (all
    positions attend)."""
    lengths = batch.get("context_lengths")
    if lengths is None:
        return None
    lengths = torch.as_tensor(lengths, device=device)
    valid = torch.arange(s_ctx, device=device)[None, :] < lengths[:, None]
    return valid.expand(n_layers, *valid.shape).clone()


@torch.no_grad()
def prefill_context(model, cfg: ModelConfig, cache: Dict,
                    batch: Dict[str, torch.Tensor]) -> Dict:
    """Fill the cross-attention K/V (in place) from the modality context:
    vlm's ``batch["image_embeds"]`` through each cross layer's
    projections, audio's ``batch["audio_embeds"]`` through the encoder
    once, then each decoder layer's ``attn_cross`` projections.  An
    optional ``batch["context_lengths"]`` (B,) masks the padded context
    positions in every decode-time cross-attention (``cross_kv["valid"]``);
    without it the mask is dropped.  Other families: a no-op."""
    if cfg.family not in ("vlm", "audio"):
        return cache
    dt = _dtype(cfg)
    ckv = cache["cross_kv"]
    if cfg.family == "vlm":
        ctx = batch["image_embeds"].to(dt)
        layers = [p["attn"] for p in model["cross_layers"]]
    else:
        ctx = _run_encoder(model, cfg, batch["audio_embeds"].to(dt))
        layers = [p["attn_cross"] for p in model["layers"]]
    for i, p in enumerate(layers):
        kv = attn.precompute_cross_kv(p, cfg, ctx)
        ckv["k"][i] = kv["k"]
        ckv["v"][i] = kv["v"]
    valid = _context_valid(batch, ctx.shape[1], len(layers), ctx.device)
    if valid is None:
        ckv.pop("valid", None)
    else:
        ckv["valid"] = valid
    return cache


def _layer_view(kvc: Dict, layer: int) -> Dict:
    """One layer's cache as views into the stacked tensors: in-place
    updates through it land in the stacked cache."""
    return {k: ({n: t[layer] for n, t in v.items()} if isinstance(v, dict)
                else v[layer]) for k, v in kvc.items()}


def reset_slot(cfg: ModelConfig, cache: Dict, slot: int) -> Dict:
    """Clear one slot's decode plan across all layers (in place) for a
    newly claimed request, and zero its recurrent state (``mamba``,
    ``rwkv``: no position axis masks it, so zeroing is the reset).  The
    K/V rows need no zeroing: every read path masks key positions
    ``<= pos``, and the new request rewrites each position before it
    becomes readable.  The cross-attention context (``cross_kv``)
    stays: it belongs to the slot, filled once by ``prefill_context``."""
    kv = _kv(cache)
    if "plan" in kv:
        reset_plan_slot(kv["plan"], slot, batch_axis=1)
    for name in ("mamba", "rwkv"):
        for t in cache.get(name, {}).values():
            t[:, slot] = 0
    return cache


def release_slot(cfg: ModelConfig, cache: Dict, slot: int) -> Dict:
    """Mark a slot's plan inactive (in place) when its request completes
    or is preempted: an empty slot must not age onto re-plan beats or
    count re-plans.  The next claim re-activates it (``reset_slot``)."""
    kv = _kv(cache)
    if "plan" in kv:
        release_plan_slot(kv["plan"], slot, batch_axis=1)
    return cache


def set_page_table(cfg: ModelConfig, cache: Dict, table,
                   page_ref=None) -> Dict:
    """Push the host allocator's page table (B, max_pages) into the
    device cache, in place, for every layer (all layers of a slot grow
    in lockstep).  ``page_ref`` (n_pages,) pushes the per-page refcounts
    alongside when the prefix cache is on — the paged write path
    write-protects shared pages (refcount > 1) with them."""
    kv = _kv(cache)
    pt = kv["page_table"]
    tbl = torch.as_tensor(np.asarray(table), dtype=torch.int32)
    pt.copy_(tbl.to(pt.device).expand_as(pt))
    if page_ref is not None and "page_ref" in kv:
        ref = torch.as_tensor(np.asarray(page_ref), dtype=torch.int32)
        kv["page_ref"].copy_(ref.to(pt.device).expand_as(kv["page_ref"]))
    return cache


def set_qos_knobs(cache: Dict, budget, interval, quant, sketch) -> Dict:
    """Push the serve loop's per-slot ladder knobs — budget / interval
    (B,) int, quant / sketch (B,) bool — into the plan state, in place.
    A rung degrades the whole slot, so every layer gets the same
    vectors."""
    plan = _kv(cache).get("plan")
    if plan is None or "budget" not in plan:
        return cache
    for name, val in (("budget", budget), ("interval", interval),
                      ("quant", quant), ("sketch", sketch)):
        t = plan[name]
        v = torch.as_tensor(np.asarray(val)).to(t.device, t.dtype)
        t.copy_(v.expand_as(t))
    return cache


def retire_plan(cfg: ModelConfig, cache: Dict, slot: int, blocks) -> Dict:
    """The plan half of a retirement pass, in place for every layer
    (``decode_plan.retire_plan_blocks``): the blocks leave the plan,
    their summaries return to the empty sentinel, their importance is
    zeroed, and the slot's planned rows are compacted over the
    survivors."""
    plan = _kv(cache).get("plan")
    if plan is not None and "live_blk" in plan:
        retire_plan_blocks(plan, slot, blocks, batch_axis=1)
    return cache


# Every per-physical-page array a page's rows live in: K/V and the
# page-summary rows (fp32 bounds, plus scale/zero under int8).  A copy on
# write or a swap moves them together — a page whose summary row stayed
# behind would rank blocks from another request's bounds.
_PAGE_POOL_FIELDS = ("k_pages", "v_pages", "page_k_min", "page_k_max",
                     "page_k_scale", "page_k_zero")


def copy_phys_pages(cache: Dict, pairs) -> Dict:
    """Copy-on-write, device side, in place: for each ``(src, dst)``
    physical page pair the allocator remapped
    (``PageAllocator.ensure_writable``) copy the K/V page rows and the
    per-page summary rows, across all layers.  Rows past the writer's
    position are masked on every read, so a whole-page copy is exact."""
    if not pairs:
        return cache
    kv = _kv(cache)
    dev = kv["k_pages"].device
    src = torch.as_tensor([s for s, _ in pairs], dtype=torch.long,
                          device=dev)
    dst = torch.as_tensor([d for _, d in pairs], dtype=torch.long,
                          device=dev)
    for f in _PAGE_POOL_FIELDS:
        if f in kv:
            kv[f][:, dst] = kv[f][:, src]
    return cache


def retire_phys_pages(cache: Dict, phys) -> Dict:
    """The device half of a retirement pass
    (``PageAllocator.retire_compact``), in place across all layers: the
    freed pages' K/V rows are zeroed and their page-summary rows return
    to the empty sentinel (fp32 ±inf; int8 codes 0 with scale −1), one
    index write per pool field.  A hole maps the overflow page, so
    nothing reads these rows; the scrub keeps a stale summary row out of
    a later prefix-cache registration."""
    if phys is None or not len(phys):
        return cache
    kv = _kv(cache)
    idx = torch.as_tensor(np.asarray(phys, np.int64),
                          device=kv["k_pages"].device)
    fill = {"k_pages": 0, "v_pages": 0, "page_k_scale": -1.0,
            "page_k_zero": 0.0}
    if "page_k_scale" in kv:                 # int8 codes: 0 is empty
        fill.update(page_k_min=0, page_k_max=0)
    else:
        fill.update(page_k_min=float("inf"), page_k_max=float("-inf"))
    for f in _PAGE_POOL_FIELDS:
        if f in kv:
            kv[f][:, idx] = fill[f]
    return cache


def gather_phys_pages(cache: Dict, phys) -> Dict[str, np.ndarray]:
    """Copy physical pages' rows to host numpy — the gather callback of
    ``PageAllocator.swap_out``.  Keys are ``"<group>.<field>"``
    (``kv_group``), as in the reference; each value holds the field's
    rows at ``phys``, in order, as an owning copy taken after the device
    work that wrote them (``.cpu()`` synchronises).  bf16 rows travel as
    their 16-bit patterns (``int16``): numpy has no bfloat16, and the
    checksums must see the real bits (they equal the reference's, whose
    ml_dtypes bfloat16 has the same bytes)."""
    name = kv_group(cache)
    kv = cache[name]
    idx = torch.as_tensor(np.asarray(phys, np.int64),
                          device=kv["k_pages"].device)
    out: Dict[str, np.ndarray] = {}
    for f in _PAGE_POOL_FIELDS:
        if f in kv:
            rows = kv[f][:, idx]                 # indexing copies
            if rows.dtype == torch.bfloat16:
                rows = rows.view(torch.int16)
            out[f"{name}.{f}"] = rows.cpu().numpy()
    return out


def scatter_phys_pages(cache: Dict, phys, payload: Dict[str, np.ndarray]
                       ) -> Dict:
    """Land a gathered payload in (freshly allocated) physical pages, in
    place — the scatter callback of ``PageAllocator.swap_in``.  ``phys``
    need not be the pages the payload came from: the table maps logical
    to physical and the plan indexes logical blocks, so any pages are
    exact."""
    name = kv_group(cache)
    kv = cache[name]
    dev = kv["k_pages"].device
    idx = torch.as_tensor(np.asarray(phys, np.int64), device=dev)
    for f in _PAGE_POOL_FIELDS:
        key = f"{name}.{f}"
        if f in kv and key in payload:
            rows = torch.from_numpy(np.ascontiguousarray(payload[key]))
            if kv[f].dtype == torch.bfloat16:
                rows = rows.view(torch.bfloat16)
            kv[f][:, idx] = rows.to(dev, kv[f].dtype)
    return cache


def capture_plan_state(cfg: ModelConfig, cache: Dict, slot: int
                       ) -> Dict[str, Dict[str, np.ndarray]]:
    """Host snapshot of one slot's decode-plan state across the layers —
    a host swap's piece besides the pages.  ``restore_plan_state`` puts
    it back reset-free: summaries, selected blocks, beat phase, churn
    and the re-plan counter resume where the victim left off."""
    name = kv_group(cache)
    if name is None or "plan" not in cache[name]:
        return {}
    return {name: capture_plan_slot(cache[name]["plan"], slot,
                                    batch_axis=1)}


def restore_plan_state(cfg: ModelConfig, cache: Dict, slot: int,
                       saved: Dict[str, Dict[str, np.ndarray]]) -> Dict:
    """Reinstall a ``capture_plan_state`` snapshot into ``slot`` (in
    place, bitwise)."""
    for name, snap in saved.items():
        install_plan_slot(cache[name]["plan"], slot, snap, batch_axis=1)
    return cache


def gather_prefix_kv(cache: Dict, table_row, prefix_len: int) -> Dict:
    """Gather a slot's first ``prefix_len`` cached K/V rows from the
    pool into the logical layout — the matched shared prefix a tail
    prefill attends over.  ``table_row``: the slot's page-table row
    (host numpy).  Returns {"k", "v"}: (L, 1, prefix_len, KV, hd)."""
    kv = cache["kv"]
    page = kv["k_pages"].shape[2]
    n_lp = -(-prefix_len // page)
    phys = torch.as_tensor(np.asarray(table_row[:n_lp]), dtype=torch.long,
                           device=kv["k_pages"].device)

    def g(pool):
        x = pool[:, phys]                        # (L, n_lp, page, KV, hd)
        x = x.reshape(x.shape[0], n_lp * page, *x.shape[3:])
        return x[:, None, :prefix_len]

    return {"k": g(kv["k_pages"]), "v": g(kv["v_pages"])}


def _dec_mlp(p, cfg, x):
    h = apply_norm(p["ln2"], cfg, x)
    if cfg.moe:
        y, _ = moe_apply(p["moe"], cfg, h)
        return x + y
    return x + mlp_apply(p["mlp"], cfg, h)


# prefill rows run in blocks of this many, aligned to absolute positions
PREFILL_ROWS = 256


@torch.no_grad()
def prefill_prompt(model, cfg: ModelConfig, tokens: torch.Tensor,
                   max_len: int, prefix_kv: Optional[Dict] = None
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence prompt prefill for serving.  Runs the decoder over
    the whole (B, S_p) prompt and returns the last position's logits
    (B, V) fp32 plus the state ``install_prefill`` places into a slot:
    ``k``/``v`` (L, B, S_p, KV, hd) and, with SATA decode on, a seeded
    per-layer ``plan`` (``plan_from_prefill``: summaries over the
    written keys, the prompt tail's selected blocks, ``step`` off the
    re-plan beat).  Attention is the dense top-k reference
    (``attn._attend``), the same selection decode uses.

    Continuation (``prefix_kv`` = {"k", "v"} (L, B, m, KV, hd), the
    matched prefix's cached rows — the shared-prefix hit path):
    ``tokens`` is the unmatched tail, run at positions ``m..m+S_p-1``
    over prefix + tail keys, and the seeded plan covers the concatenated
    keys, as a full-prompt prefill's would.

    Every operation on rows runs once per block of ``PREFILL_ROWS``
    positions, aligned to position 0, and attends over all the prompt's
    keys.  A continuation computes from the block holding position ``m``
    (the rows before ``m`` in it take zero inputs; their keys and values
    come from the prefix, their outputs are dropped), so each of its
    rows goes through the operations, at the shapes, that a full prefill
    gives that row.  On the card cuBLAS and the reductions choose their
    summation order by shape, so only this makes a cache hit's tail,
    logits and plan bitwise a miss's.

    The moe FFN is the exception: capacity couples the tokens of a
    group, so it runs once over exactly the rows the reference's call
    sees (the whole prompt on a miss, the unmatched tail on a hit, in
    order), never by block and never on the pad rows.  A moe hit's tail
    therefore equals the reference's continuation prefill, not a miss
    (the reference's own hit and miss differ there too)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"prefill_prompt covers the dense/moe serving families "
            f"(got {cfg.family!r}) — other families prefill token-by-"
            f"token through serve_step")
    b, sp = tokens.shape
    m = 0 if prefix_kv is None else int(prefix_kv["k"].shape[2])
    # strictly less: the first decode step writes at pos == m + sp
    assert m + sp < max_len, (m, sp, max_len)
    dt = _dtype(cfg)
    kvh, hd = cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // kvh
    seed_plan = attn.sata_decode_on(cfg, max_len)
    blk = attn.decode_block_size(cfg, max_len)
    dev = tokens.device
    total = m + sp
    start = m - m % PREFILL_ROWS               # first computed row
    pad = m - start                             # rows before m in its block
    positions = torch.arange(start, total, device=dev)
    k_positions = torch.arange(total, device=dev)
    x = embed_apply(model["embed"], tokens).to(dt)
    x = torch.cat([x.new_zeros((b, pad) + x.shape[2:]), x], dim=1)
    cuts = [(a - start, min(a + PREFILL_ROWS, total) - start)
            for a in range(start, total, PREFILL_ROWS)]

    def by_block(fn, *ts):
        outs = [fn(*(t[:, lo:hi] for t in ts)) for lo, hi in cuts]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o, dim=1) for o in zip(*outs))
        return torch.cat(outs, dim=1)

    ks, vs, seeds = [], [], []
    for i, p in enumerate(model["layers"]):
        hn = by_block(lambda t: apply_norm(p["ln1"], cfg, t), x)
        q, k, v = by_block(lambda t: attn._project_qkv(p["attn"], cfg, t), hn)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        kc, vc = k[:, pad:].to(dt), v[:, pad:].to(dt)
        k_all, v_all = kc, vc
        if prefix_kv is not None:
            # the cached prefix rows are bitwise the rows the skipped
            # positions would produce, so this is the full prefill's math
            k_all = torch.cat([prefix_kv["k"][i], kc], dim=1)
            v_all = torch.cat([prefix_kv["v"][i], vc], dim=1)
        out = by_block(lambda qb, pb: attn._attend(
            qb, k_all, v_all, cfg, pb[0], k_positions, causal=True),
            q, positions[None])
        y = by_block(lambda t: t.reshape(b, t.shape[1], cfg.n_heads * hd)
                     @ p["attn"]["wo"], out)
        if cfg.moe:
            x = by_block(lambda t, u: t + u, x, y)
            hn = by_block(lambda t: apply_norm(p["ln2"], cfg, t), x)
            f, _ = moe_apply(p["moe"], cfg, hn[:, pad:])
            x = torch.cat([x[:, :pad], x[:, pad:] + f], dim=1)
        else:
            x = by_block(lambda t, u: _dec_mlp(p, cfg, t + u), x, y)
        ks.append(kc)
        vs.append(vc)
        if seed_plan:
            # seed from the WRITTEN keys, padded to the logical length
            k_pad = torch.zeros((b, max_len, kvh, hd), dtype=dt, device=dev)
            k_pad[:, :total] = k_all
            seeds.append(plan_from_prefill(
                k_pad, q[:, -1].reshape(b, kvh, g, hd),
                torch.full((b,), total - 1, dtype=torch.int32, device=dev),
                topk_k=cfg.topk_k, k_block=blk,
                plan_blocks=cfg.sata.decode.blocks,
                summary=cfg.sata.decode.summary))
    x = apply_norm(model["final_ln"], cfg, x[:, -1:])
    logits = unembed_apply(model["embed"], cfg, x)
    state = {"k": torch.stack(ks), "v": torch.stack(vs)}
    if seed_plan:
        state["plan"] = {n: torch.stack([s[n] for s in seeds])
                         for n in seeds[0]}
    return logits[:, 0], state


def install_prefill(cfg: ModelConfig, cache: Dict, slot: int,
                    state: Dict[str, Any], phys_pages=None, *,
                    prefix_len: int = 0) -> Dict:
    """Place one prefilled request (``prefill_prompt`` output, B=1) into
    serving slot ``slot``, in place: the prompt K/V rows into the slot's
    contiguous region or, paged, scattered through ``phys_pages`` (the
    slot's mapped pages in logical order), and the seeded plan rows into
    the slot's plan state.

    ``prefix_len > 0`` is the shared-prefix install (paged only):
    ``state`` came from a continuation prefill over the unmatched tail
    and the matched pages are already mapped, so only the tail rows are
    written.  With the per-page summary arrays in the cache, the plan
    summaries of fully matched blocks are seeded FROM the summary cache
    (bit-identical to the seed's recompute under either backend), and
    every full prompt page's summary row is (re)registered for later
    hits."""
    ks, vs = state["k"], state["v"]                   # (L, 1, S_p, KV, hd)
    sp = ks.shape[2]
    total = prefix_len + sp
    kv = cache["kv"]
    seed = state.get("plan")
    if "k_pages" in kv:
        assert phys_pages is not None, "paged install needs the pages"
        page = kv["k_pages"].shape[2]
        row = np.asarray(phys_pages).reshape(-1)
        assert row.shape[0] * page >= total, (row.shape[0], page, total)
        tok = np.arange(prefix_len, total)
        dev = kv["k_pages"].device
        phys_w = torch.as_tensor(row[tok // page], dtype=torch.long,
                                 device=dev)
        off_w = torch.as_tensor(tok % page, dtype=torch.long, device=dev)
        kv["k_pages"][:, phys_w, off_w] = ks[:, 0].to(kv["k_pages"].dtype)
        kv["v_pages"][:, phys_w, off_w] = vs[:, 0].to(kv["v_pages"].dtype)
        if seed is not None and "page_k_min" in kv:
            _seed_page_summaries(kv, seed, row, prefix_len // page,
                                 total // page)
    else:
        assert prefix_len == 0, "shared-prefix install is paged-only"
        kv["k"][:, slot, :sp] = ks[:, 0].to(kv["k"].dtype)
        kv["v"][:, slot, :sp] = vs[:, 0].to(kv["v"].dtype)
    if seed is not None and "plan" in kv:
        for name in _SEED_FIELDS:
            if name in kv["plan"]:
                kv["plan"][name][:, slot] = seed[name][:, 0]
    return cache


# page-summary array → its plan-state field; bounds are (.., KV, D) per
# page and (.., KV, nkb, D) in the plan, scale/zero drop the D axis
_PAGE_SUMMARY = (("page_k_min", "k_min"), ("page_k_max", "k_max"),
                 ("page_k_scale", "k_scale"), ("page_k_zero", "k_zero"))


def _seed_page_summaries(kv: Dict, seed: Dict, row: np.ndarray,
                         n_shared: int, n_full: int) -> None:
    """The install's summary-cache step, in place: the seed's first
    ``n_shared`` blocks (fully matched pages) take the cached page rows,
    then the first ``n_full`` blocks (full prompt pages) are written back
    to the cache.  ``seed`` holds (L, 1, KV, nkb, ...) plan fields."""
    dev = kv["page_k_min"].device
    for page_f, plan_f in _PAGE_SUMMARY:
        if page_f not in kv:
            continue
        if n_shared:
            ph = torch.as_tensor(row[:n_shared], dtype=torch.long,
                                 device=dev)
            seed[plan_f][:, 0, :, :n_shared] = \
                kv[page_f][:, ph].transpose(1, 2)
        if n_full:
            ph = torch.as_tensor(row[:n_full], dtype=torch.long, device=dev)
            kv[page_f][:, ph] = seed[plan_f][:, 0, :, :n_full].transpose(1, 2)


def _write_state(view: Dict, new: Dict) -> None:
    for n, t in new.items():
        view[n].copy_(t)


def shared_block_decode(model, cfg: ModelConfig, x: torch.Tensor,
                        x0: torch.Tensor, kvc: Dict, pos) -> torch.Tensor:
    """hybrid: one application of the shared decoder block to
    ``concat(x, x0) @ shared_in`` against its own KV cache ``kvc`` (a
    layer view, updated in place); only the block's delta is added to
    ``x``."""
    cat = torch.cat([x, x0], dim=-1) @ model["shared_in"]
    sp = model["shared_attn"]
    y, _ = attn.attention_decode(sp["attn"], cfg, apply_norm(sp["ln1"], cfg,
                                                             cat), kvc, pos)
    return x + (_dec_mlp(sp, cfg, cat + y) - cat)


def _hybrid_layers(model, cfg: ModelConfig, cache: Dict, x: torch.Tensor,
                   pos) -> torch.Tensor:
    x0 = x               # the current token's embedding, as in forward
    for i, p in enumerate(model["layers"]):
        view = _layer_view(cache["mamba"], i)
        y, new = mamba2_decode(p["mixer"], cfg, apply_norm(p["ln"], cfg, x),
                               view)
        _write_state(view, new)
        x = x + y
        if (i + 1) % cfg.hybrid_period == 0:
            x = shared_block_decode(
                model, cfg, x, x0, _layer_view(
                    cache["shared_kv"], i // cfg.hybrid_period), pos)
    return x


def _ssm_layers(model, cfg: ModelConfig, cache: Dict, x: torch.Tensor
                ) -> torch.Tensor:
    for i, p in enumerate(model["layers"]):
        c = _layer_view(cache["rwkv"], i)
        y, state, tm_x = rwkv6_time_mix(p["tmix"], cfg,
                                        apply_norm(p["ln1"], cfg, x),
                                        state=c["state"], last_x=c["tm_x"])
        x = x + y
        y, cm_x = rwkv6_channel_mix(p["tmix"], cfg,
                                    apply_norm(p["ln2"], cfg, x),
                                    last_x=c["cm_x"])
        x = x + y
        _write_state(c, {"state": state, "tm_x": tm_x, "cm_x": cm_x})
    return x


@torch.no_grad()
def serve_step(model, cfg: ModelConfig, cache: Dict, tokens: torch.Tensor,
               pos) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, 1) current token ids; pos: scalar or (B,) per-slot
    positions.  → (logits (B, 1, V) fp32, cache updated in place).  vlm
    runs a gated cross layer over ``cross_kv`` after each group of self
    layers; audio a cross-attention in every layer; hybrid the shared
    block after every ``hybrid_period`` mamba steps; ssm the rwkv6 time
    and channel mix of every layer."""
    _check_family(cfg)
    x = embed_apply(model["embed"], tokens).to(_dtype(cfg))
    if cfg.family == "hybrid":
        x = _hybrid_layers(model, cfg, cache, x, pos)
    elif cfg.family == "ssm":
        x = _ssm_layers(model, cfg, cache, x)
    else:
        x = _attention_layers(model, cfg, cache, x, pos)
    x = apply_norm(model["final_ln"], cfg, x)
    return unembed_apply(model["embed"], cfg, x), cache


def _attention_layers(model, cfg: ModelConfig, cache: Dict, x: torch.Tensor,
                      pos) -> torch.Tensor:
    """dense / moe / vlm / audio: a self-attention decode step per layer
    (and vlm's cross layers, audio's cross-attention)."""
    ckv = cache.get("cross_kv")

    def context(i):
        return {n: t[i] for n, t in ckv.items()}

    per_group = (len(model["layers"]) // len(model["cross_layers"])
                 if cfg.family == "vlm" else 0)
    for i, p in enumerate(model["layers"]):
        hn = apply_norm(p["ln1"], cfg, x)
        y, _ = attn.attention_decode(p["attn"], cfg, hn,
                                     _layer_view(cache["kv"], i), pos)
        if cfg.family == "audio":
            x = x + y
            hn = apply_norm(p["lnx"], cfg, x)
            x = x + attn.cross_attention_decode(p["attn_cross"], cfg, hn,
                                                context(i))
            x = x + mlp_apply(p["mlp"], cfg, apply_norm(p["ln2"], cfg, x))
            continue
        x = _dec_mlp(p, cfg, x + y)
        if per_group and (i + 1) % per_group == 0:
            g = i // per_group
            cp = model["cross_layers"][g]
            hn = apply_norm(cp["ln1"], cfg, x)
            y = attn.cross_attention_decode(cp["attn"], cfg, hn, context(g))
            x = x + torch.tanh(cp["gate"]).to(x.dtype) * y
            hn = apply_norm(cp["ln2"], cfg, x)
            x = x + torch.tanh(cp["gate_mlp"]).to(x.dtype) * mlp_apply(
                cp["mlp"], cfg, hn)
    return x
