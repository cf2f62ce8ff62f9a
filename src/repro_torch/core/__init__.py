"""The cost plane of SkyStore's adaptive-TTL placement, in PyTorch.

Public surface (each mirrors the ``repro.core`` module of the same name):
  api         -- the typed requests a trace replays as, and the shared
                 placement rules
  costmodel   -- region catalogs, egress matrices, T_even, latency model
  histogram   -- 800-cell access histograms on float64 CPU tensors
  ttl_policy  -- ExpectedCost(TTL), argmin scan, adaptive controller
  policies    -- SkyStore + every §6.2.2 baseline, make_policy
  oracle      -- trace-backed future knowledge for CGP and SPANStore
  simulator   -- the event-driven monetary-cost simulator, run_policy
  expiry      -- the lazy-expiration index
  engine      -- the virtual-time event spine
  routing     -- GET routing over float64 CPU tensors
  ledger      -- CostReport
  traces      -- synthetic IBM-trace profiles + workload types A-E
  workloads   -- parameterized generators and outage schedules
"""

from .api import (  # noqa: F401
    ApiError,
    DeleteObjectRequest,
    GetRequest,
    HeadRequest,
    ListRequest,
    PutRequest,
    choose_get_source,
    resolve_put_placement,
)
from .costmodel import (  # noqa: F401
    CostModel,
    Region,
    default_catalog,
    paper_2region_catalog,
    pick_regions,
    tpu_tier_catalog,
)
from .engine import EventSpine, OutageSchedule, SpineEvent  # noqa: F401
from .expiry import ExpiryIndex, KeyInterner  # noqa: F401
from .histogram import (  # noqa: F401
    AccessHistogram, RollingHistogram, cell_edges, from_numpy,
)
from .ledger import CostReport  # noqa: F401
from .oracle import TraceOracle  # noqa: F401
from .policies import Policy, make_policy  # noqa: F401
from .simulator import Simulator, run_policy  # noqa: F401
from .traces import Trace  # noqa: F401
from .ttl_policy import (  # noqa: F401
    AdaptiveTTLController,
    choose_ttl,
    choose_ttl_with_perf_value,
    expected_cost_curve,
)
from .workloads import (  # noqa: F401
    WORKLOAD_NAMES, make_outage_schedule, make_workload,
)
