"""SATA core — the paper's primary contribution, ported.

Sorting (Algo 1), FSM scheduling (Algo 2), tiling + zero-skip
(Sec. III-D), the CIM estimation framework (Sec. IV), and the
block-sparse execution planner of the prefill kernels derived from them.
"""
from repro_torch.core.blockmap import (block_occupancy, block_skip_fraction,
                                       compact_kv_plan, identity_block_plan,
                                       sata_block_plan)
from repro_torch.core.masks import (SyntheticTrace, apply_selective_mask,
                                    synthetic_masks, synthetic_scores,
                                    topk_mask)
from repro_torch.core.sata import SataPlan, SataStats, plan, stats_from_results
from repro_torch.core.scheduling import (Schedule, Step, build_schedule,
                                         coverage_ok, schedule_heads)
from repro_torch.core.simulator import (HwConfig, SimReport, scheduler_cost,
                                        simulate_dense, simulate_gated,
                                        simulate_schedule,
                                        simulate_tiled_sata)
from repro_torch.core.sorting import (HeadType, QType, SortResult,
                                      classify_queries, classify_with_escape,
                                      locality_score, sort_and_classify,
                                      sort_keys, sort_keys_direct,
                                      sort_keys_psum)
from repro_torch.core.tiling import TiledPlan, Tile, plan_tiled, tiled_schedule
