"""dspc: the paper's own workload (dynamic SPC-Index maintenance).

The port's own copy of ``repro.configs.dspc``, values verbatim.  Only
the graph shape and the construction / update / serving knobs are read
by this slice of the port; the fleet, analytics and front-door knobs
stay so that one configuration describes the whole system as the
reference does.  ``SMOKE`` is the CPU test size, ``CONFIG`` the size
``chip_smoke.py`` drives on the card.
"""

import dataclasses

from repro_torch.configs.common import DSPC_SHAPES, ArchSpec


@dataclasses.dataclass(frozen=True)
class DSPCArchConfig:
    name: str = "dspc"
    n: int = 65536            # vertices
    m: int = 524288           # undirected edges
    l_cap: int = 64           # label capacity per vertex
    query_batch: int = 1_048_576
    # -- construction knobs (repro_torch.core.construct) ----------------
    construct_batch: int = 32   # hubs per batched-build round (PSPC);
    # None / < 2 falls back to the sequential one-hub-per-round builder
    vertex_order: str = "id"    # "id" | "degree" hub-ordering strategy
    # -- service knobs ---------------------------------------------------
    update_batch: int = 64    # events per apply_events chunk
    queue_size: int = 8       # bounded ingest queue (backpressure point)
    replicas: int = 2         # QueryEngine replicas readers round-robin
    route: str = "auto"       # default RoutePolicy kind for readers
    # -- fleet knobs -----------------------------------------------------
    role: str = "updater"       # "updater" publishes | "replica" pulls
    transport: str | None = None  # "local" | "dir" | "socket"
    publish_dir: str | None = None  # the shared publication directory
    poll_interval_s: float = 0.05   # replica staleness bound (polling)
    # -- analytics knobs -------------------------------------------------
    analytics_pair_sample: int = 512  # sampled (s, t) betweenness workload
    analytics_top_k: int = 16         # maintained top-k size
    analytics_v_block: int = 256      # candidate-vertex tile per dispatch
    # -- front-door knobs ------------------------------------------------
    max_live_batches: int = 4   # admission bound, in coalesced batches
    dispatchers: int = 2        # coalescing dispatcher threads
    deadline_s: float = 5.0     # default per-request SLO
    frontdoor_batch: int = 256  # pairs per coalesced dispatch (bucket cap)


CONFIG = DSPCArchConfig()
SMOKE = DSPCArchConfig(name="dspc-smoke", n=64, m=160, l_cap=16,
                       query_batch=256, construct_batch=8,
                       update_batch=8, queue_size=4,
                       replicas=2, max_live_batches=2, dispatchers=2,
                       deadline_s=10.0, frontdoor_batch=64,
                       analytics_pair_sample=64, analytics_top_k=8,
                       analytics_v_block=64)

SPEC = ArchSpec(arch_id="dspc", family="dspc", config=CONFIG, smoke=SMOKE,
                shapes=DSPC_SHAPES,
                source="this paper (Feng et al., 2023)")
