"""The ranks of ``tests/test_torch_mesh.py``, and the inputs both sides
make from numpy seeds.

    python tests/torch_mesh_ranks.py RANK WORLD STORE OUT

joins a gloo world through the ``FileStore`` at STORE (a file that must
not exist yet), builds ``make_shard_mesh(WORLD)`` on the CPU, runs every
case of :func:`run_cases` and the refusals, and writes the results with
``torch.save`` to OUT.  The test starts the ranks once per module and
compares their gathered results with the single-device run of the same
cases (``run_cases(make_local_mesh(device="cpu"))``).  The sizes are
``tests/test_mesh_serving.py``'s."""
import sys

import numpy as np

import torch_threads  # noqa: F401  (one intra-op thread)
import torch

from repro_torch.core.decode_plan import init_decode_plan
from repro_torch.launch import mesh as M

BH, S, SK, D = 4, 64, 64, 16
B, KV, G, SMAX, KB = 2, 8, 2, 64, 8
K_SEL = TOPK = 8
SEQ_SEEDS = (0, 1)
LAYOUTS = ("contiguous", "paged")


def qkv(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((BH, n, D)).astype(np.float32)
                 for n in (S, SK, SK))


def decode_inputs(seed=2):
    """One step's (qg, k cache, v cache, k_new, pos): slots at position
    32, the cache zero past it."""
    rng = np.random.default_rng(seed)
    pos0 = 32
    kc = rng.standard_normal((B, SMAX, KV, D)).astype(np.float32)
    vc = rng.standard_normal((B, SMAX, KV, D)).astype(np.float32)
    kc[:, pos0 + 1:] = 0.0
    vc[:, pos0 + 1:] = 0.0
    qg = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    return qg, kc, vc, kc[:, pos0:pos0 + 1], np.full((B,), pos0, np.int32)


def carry_inputs(seed=3, steps=3):
    """Three steps' (qg, k_new, v_new, pos) over an empty cache."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        kn = rng.standard_normal((B, 1, KV, D)).astype(np.float32)
        vn = rng.standard_normal((B, 1, KV, D)).astype(np.float32)
        qg = rng.standard_normal((B, KV, G, D)).astype(np.float32)
        out.append((qg, kn, vn, np.full((B,), 16 + step, np.int32)))
    return out


def page_table(seed=4):
    """A shuffled (B, SMAX // KB) table over a pool of B·nkb + 1 pages."""
    nkb = SMAX // KB
    perm = np.random.default_rng(seed).permutation(np.arange(1, B * nkb + 1))
    return perm.reshape(B, nkb).astype(np.int32)


def to_pool(cache, table):
    """The contiguous (B, SMAX, KV, D) cache laid out as the pool
    (n_pages, KB, KV, D) through ``table``."""
    pool = np.zeros((B * (SMAX // KB) + 1, KB, KV, cache.shape[-1]),
                    cache.dtype)
    pool[table] = cache.reshape(B, SMAX // KB, KB, KV, -1)
    return pool


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def decode_steps(step_fn, layout, carry):
    """Run ``step_fn(qg, k, v, k_new, pos, plan, page_table)`` over the
    one-step inputs (``carry=False``) or the three carried steps, from
    a fresh plan; returns each step's (out, plan)."""
    table = page_table()
    plan = init_decode_plan(B, KV, SMAX, D, KB, device="cpu")
    if carry:
        kc = np.zeros((B, SMAX, KV, D), np.float32)
        vc = np.zeros_like(kc)
        steps = []
        for qg, kn, vn, pos in carry_inputs():
            kc[:, pos[0]] = kn[:, 0]
            vc[:, pos[0]] = vn[:, 0]
            steps.append((qg, kc.copy(), vc.copy(), kn, pos))
    else:
        steps = [decode_inputs()]
    outs = []
    for qg, kc, vc, kn, pos in steps:
        if layout == "paged":
            kc, vc = to_pool(kc, table), to_pool(vc, table)
        out, plan = step_fn(*_t(qg, kc, vc, kn, pos), plan,
                            None if layout == "contiguous"
                            else torch.from_numpy(table))
        outs.append((out, plan))
    return outs


def run_cases(mesh):
    """Every sharded case on ``mesh``: the sequence-sharded attention at
    each seed, the tensor-parallel decode step in both layouts (one step
    and a 3-step carry)."""
    res = {}
    for seed in SEQ_SEEDS:
        res[f"seq{seed}"] = M.sequence_sharded_attention(
            mesh, *_t(*qkv(seed)), k_sel=K_SEL, q_block=8, k_block=8)

    def tp(qg, k, v, kn, pos, plan, table):
        return M.tensor_parallel_decode_step(
            mesh, qg, k, v, kn, pos, plan, topk_k=TOPK, k_block=KB,
            replan_interval=1, page_table=table)

    for layout in LAYOUTS:
        for carry in (False, True):
            res[f"tp_{layout}_{'carry' if carry else 'one'}"] = \
                decode_steps(tp, layout, carry)
    return res


def _error(fn):
    try:
        fn()
    except Exception as e:  # the refusal is the result: type and text
        return type(e).__name__, str(e)
    return None


def refusals(mesh):
    """The reference's refusals, each as (exception type, message)."""
    from repro_torch.launch.train import train
    qg, kc, vc, kn, pos = _t(*decode_inputs())
    h = 3                                        # KV = 3 over 2 ranks
    plan = init_decode_plan(B, h, SMAX, D, KB, device="cpu")
    q, k, v = _t(*qkv(0))
    return {
        "make_shard_mesh(4)": _error(lambda: M.make_shard_mesh(
            4, device="cpu")),
        "kv_not_tiling": _error(lambda: M.tensor_parallel_decode_step(
            mesh, qg[:, :h], kc[:, :, :h], vc[:, :, :h], kn[:, :, :h], pos,
            plan, topk_k=TOPK, k_block=KB)),
        "sq_not_tiling": _error(lambda: M.sequence_sharded_attention(
            mesh, q[:, :24], k, v, k_sel=K_SEL, q_block=8, k_block=8)),
        "train_on_two_ranks": _error(lambda: train(
            "qwen3-4b", steps=1, batch=1, seq=8, mesh=mesh, device="cpu")),
    }


def main(rank, world, store, out):
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = M.make_shard_mesh(world, device="cpu")
        res = run_cases(mesh)
        res["refusals"] = refusals(mesh)
        one = M.make_shard_mesh(1, device="cpu")
        res["one_rank_mesh"] = (one.shape, one.group, one.coord("shard"))
        res["host_staged_bytes"] = mesh.host_staged_bytes
        torch.save(res, out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
