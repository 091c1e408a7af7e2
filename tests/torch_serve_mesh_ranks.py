"""The ranks of ``tests/test_torch_serve_mesh.py`` and the cases both use.

    python tests/torch_serve_mesh_ranks.py RANK WORLD TMP

joins a gloo world of WORLD ranks through the ``FileStore`` at
TMP/store<WORLD>, runs :func:`run_world` and has rank 0 write every
rank's results to TMP/world<WORLD>.pt (``torch.save``).  World 2 runs
the (1, 2) and (2, 1) meshes, world 4 the (2, 2) mesh, each with the
weights in "infer_tp" mode (whole over "data"), and world 4 also
:data:`TRAIN_MODE` in "train" mode (FSDP over "data").

Every case (:data:`CASES`: a family of SMOKE configs and a cache
layout) fills one whole serving cache (:func:`fill_cache`: every slot
at its own position of :data:`START`), runs :data:`STEPS` teacher-forced
``models.decode.serve_step``s on one device, then the same steps
through ``train.step.make_serve_step(cfg, mesh=, mode=)`` on the rank's
blocks of the same cache, fed one device's greedy tokens.  The worlds
run the head layout of the serving cache (``CACHE_SEQ_SHARD`` False;
the key split's cases are ``tests/torch_cp_decode_ranks.py``'s).  The
backends (:class:`Port`, and the test's JAX one) give the package's
functions, so the reference runs the same cases in the test process.
"""
import dataclasses
import os
import sys

import numpy as np

# family: the SMOKE arch and the cache layouts it serves
FAMILIES = {"dense": "qwen3-4b", "moe": "qwen3-moe-235b-a22b",
            "vlm": "llama-3.2-vision-90b", "audio": "whisper-base",
            "hybrid": "zamba2-2.7b", "ssm": "rwkv6-1.6b"}
CASES = {"dense": ("contiguous", "paged"), "moe": ("contiguous",),
         "vlm": ("contiguous",), "audio": ("contiguous",),
         "hybrid": ("contiguous", "paged"), "ssm": ("contiguous",)}
B, MAX_LEN, STEPS, PAGE = 4, 64, 3, 8
# each slot's position at step 0: dense and moe slots hold a prompt of
# that many tokens, the other families start there from an empty cache
START = (6, 10, 4, 12)
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
# the (mesh, family) that also runs with the weights in "train" mode
TRAIN_MODE = ((2, 2), "dense")
SEED = 28


def case_cfg(smoke, dec_cls, kv_cls, family, layout):
    """The case's config from a package's SMOKE and its config classes:
    the serve example's decode (bisect, SATA decode on, 8-token blocks,
    exact re-plan every step).  dense takes 4 query heads over 2 KV
    heads (one KV head a rank at m = 2); moe keeps SMOKE's group of 16
    tokens, more than a data rank's rows, so a rank routes the gathered
    batch."""
    base = smoke[FAMILIES[family]]
    over = {}
    if family == "dense":
        over["n_kv_heads"] = 2
    sata = dataclasses.replace(base.sata, decode=dec_cls(
        mode="on", block=PAGE, replan=1))
    return dataclasses.replace(base, topk_impl="bisect", sata=sata,
                               kv=kv_cls(layout=layout), **over)


class Port:
    """The port's side of a case, on the CPU."""

    def __init__(self):
        import torch
        from repro_torch.configs.archs import SMOKE
        from repro_torch.core.paging import PageAllocator
        from repro_torch.models import decode
        from repro_torch.models.config import KVCacheConfig, SataDecodeConfig
        self.torch, self.dec, self.alloc = torch, decode, PageAllocator
        self.smoke, self.dec_cls, self.kv_cls = (SMOKE, SataDecodeConfig,
                                                 KVCacheConfig)

    def cfg(self, family, layout):
        return case_cfg(self.smoke, self.dec_cls, self.kv_cls, family,
                        layout)

    def init_cache(self, cfg):
        return self.dec.init_cache(cfg, B, MAX_LEN, device="cpu")

    def to(self, a):
        return self.torch.from_numpy(np.ascontiguousarray(a))

    def step(self, model, cfg, cache, tok, pos):
        lg, cache = self.dec.serve_step(model, cfg, cache, self.to(tok),
                                        self.to(pos))
        return lg.numpy(), cache


def fill_cache(be, model, cfg, family, layout, start=START, lengths=None):
    """The whole serving cache before step 0 and the step-0 tokens
    (numpy, from SEED): paged, every slot's pages mapped; dense and moe
    slots prefilled with a prompt of ``start[s]`` tokens
    (``prefill_prompt`` → ``install_prefill``); vlm and audio contexts
    through ``prefill_context``, with ``lengths`` as its
    ``context_lengths`` if given."""
    rng = np.random.default_rng(SEED)
    cache = be.init_cache(cfg)
    table = None
    if layout == "paged":
        alloc = be.alloc(B * (MAX_LEN // PAGE) + 1, B, MAX_LEN // PAGE, PAGE,
                         audit=False)
        for s in range(B):
            assert alloc.ensure(s, MAX_LEN - 1)
        table = alloc.table
        cache = be.dec.set_page_table(cfg, cache, table)
    if family in ("vlm", "audio"):
        key, n = (("image_embeds", cfg.n_image_tokens) if family == "vlm"
                  else ("audio_embeds", cfg.encoder_len))
        ctx = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
        batch = {key: be.to(ctx)}
        if lengths is not None:
            batch["context_lengths"] = be.to(np.asarray(lengths, np.int32))
        cache = be.dec.prefill_context(model, cfg, cache, batch)
    if family in ("dense", "moe"):
        for s in range(B):
            prompt = rng.integers(0, cfg.vocab_size, (1, start[s])).astype(
                np.int32)
            _, state = be.dec.prefill_prompt(model, cfg, be.to(prompt),
                                             MAX_LEN)
            cache = be.dec.install_prefill(
                cfg, cache, s, state, None if table is None else table[s])
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    return cache, tok


def drive(step, cache, tok, feed=None, start=START):
    """STEPS steps of ``step(cache, tok, pos)`` → (logits, cache) from
    ``start``: each step's logits (numpy) and the tokens fed, the next
    step's being ``feed``'s or this step's argmax."""
    pos = np.array(start, np.int32)
    logits, fed = [], []
    for i in range(STEPS):
        if feed is not None:
            tok = feed[i]
        fed.append(tok)
        lg, cache = step(cache, tok, pos)
        logits.append(lg)
        tok = np.argmax(lg[:, 0], axis=-1)[:, None].astype(np.int32)
        pos = pos + 1
    return logits, fed, cache


def plan_rows(cache):
    """Layer 0's plan rows (kv_indices, kv_counts) of the cache's
    self-attention group, or None (ssm)."""
    for group in ("kv", "shared_kv"):
        if group in cache and "plan" in cache[group]:
            plan = cache[group]["plan"]
            return tuple(np.array(plan[f][0]) for f in ("kv_indices",
                                                        "kv_counts"))
    return None


_ONE = {}


def one_device(be, family, layout):
    """One device's run of a case (memoised): the logits, the tokens fed
    and layer 0's plan rows after step 0."""
    key = (family, layout)
    if key not in _ONE:
        from repro_torch.models.model import Model
        cfg = be.cfg(family, layout)
        model = Model(cfg, device="cpu", seed=0)
        cache, tok = fill_cache(be, model, cfg, family, layout)
        first = []

        def step(c, t, p):
            out = be.step(model, cfg, c, t, p)
            if not first:
                first.append(plan_rows(out[1]))
            return out
        logits, fed, _ = drive(step, cache, tok)
        _ONE[key] = dict(logits=logits, fed=fed, plan0=first[0])
    return _ONE[key]


def mesh_case(be, mesh, family, layout, mode, roundtrip):
    """The case on ``mesh``: the seed-0 model sharded under ``mode``
    (``init_train_state(mesh=, mode=)``), the rank's blocks of the whole
    cache, STEPS mesh steps fed one device's tokens; layer 0's plan rows
    after step 0 gathered whole; with ``roundtrip``, whether the whole
    cache's blocks gather back to it bitwise."""
    from repro_torch.distributed.sharding import cache_leaves
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import init_train_state, make_serve_step
    cfg = be.cfg(family, layout)
    ref = one_device(be, family, layout)
    whole, _ = fill_cache(be, Model(cfg, device="cpu", seed=0), cfg, family,
                          layout)
    model = init_train_state(cfg, OptConfig(), device="cpu", seed=0,
                             mesh=mesh, mode=mode)["params"]
    step = make_serve_step(cfg, mesh=mesh, mode=mode)
    layout_ = step.layout
    cache = layout_.block_cache(whole)
    out = {"counts": layout_.counts()}
    if roundtrip:
        back = layout_.gather_cache(cache, whole)
        out["roundtrip"] = _equal_trees(back, whole)
    first = []

    def run(c, t, p):
        lg, c = step(model, c, be.to(t), be.to(p))
        if not first:
            first.append(plan_rows(layout_.gather_cache(c, whole)))
        return lg.numpy(), c
    logits, _, _ = drive(run, cache, None, feed=ref["fed"])
    out.update(logits=logits, plan0=first[0], one=ref,
               shapes={"cache": {"/".join(p): tuple(t.shape) for p, t in
                                 cache_leaves(cache)}})
    return out


def _equal_trees(a, b):
    import torch
    from repro_torch.distributed.sharding import cache_leaves
    la, lb = dict(cache_leaves(a)), dict(cache_leaves(b))
    return sorted(la) == sorted(lb) and all(
        la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]) for k in la)


def run_world(rank, world, tmp):
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_train_mesh
    # these cases hold the head-parallel cache layout (the key split's
    # are tests/test_torch_cp_decode.py's)
    sharding.CACHE_SEQ_SHARD = False
    be = Port()
    res = {}
    for i, shape in enumerate(MESHES[world]):
        mesh = make_train_mesh(*shape, device="cpu")
        for family, layouts in CASES.items():
            for layout in layouts:
                res[(shape, family, layout, "infer_tp")] = mesh_case(
                    be, mesh, family, layout, "infer_tp", roundtrip=i == 0)
        if shape == TRAIN_MODE[0]:
            res[(shape, TRAIN_MODE[1], "contiguous", "train")] = mesh_case(
                be, mesh, TRAIN_MODE[1], "contiguous", "train",
                roundtrip=True)
    return res


def main_rank(rank, world, tmp):
    import torch_threads  # noqa: F401  (one intra-op thread)
    import torch
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp}/store{world}", rank=rank,
        world_size=world)
    try:
        res = run_world(rank, world, tmp)
        parts = [None] * world
        torch.distributed.all_gather_object(parts, res)
        if rank == 0:
            torch.save(parts, os.path.join(tmp, f"world{world}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
