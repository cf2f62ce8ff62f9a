"""SkyStore core in PyTorch: the cost plane, the live plane and its S3 surface.

Public surface (each mirrors the ``repro.core`` module of the same name):
  api            -- the unified typed op layer (ObjectStoreAPI) every data
                    plane implements: VirtualStore, the S3Proxy wire codec
                    and the Simulator all speak the same request objects
  costmodel      -- region catalogs, egress matrices, T_even, latency model
  histogram      -- 800-cell access histograms on float64 CPU tensors
  ttl_policy     -- ExpectedCost(TTL), argmin scan, adaptive controller
  policies       -- SkyStore + every §6.2.2 baseline, make_policy
  oracle         -- trace-backed future knowledge for CGP and SPANStore
  simulator      -- the event-driven monetary-cost simulator, run_policy
  expiry         -- the lazy-expiration index
  engine         -- the virtual-time event spine
  routing        -- GET routing over float64 CPU tensors
  ledger         -- CostReport + the live-plane CostLedger
  replay         -- differential trace replay: Simulator vs live
                    VirtualStore, checked against the golden fixtures
                    (python -m repro_torch.core.replay --check-golden)
  traces         -- synthetic IBM-trace profiles + workload types A-E
  workloads      -- parameterized generators and outage schedules
  metadata       -- control plane (2PC, versioning, eviction scan, backup)
  virtual_store  -- client-facing virtual bucket/object API; accepts any
                    Policy via VirtualStore(policy=...) for live placement
  backends       -- physical per-region stores (memory / filesystem)
  s3_proxy       -- the S3 wire codec and HTTP endpoint over a store
  lifecycle      -- learned TTLs compiled into provider lifecycle rules

The entry points that reach a TTL controller (``make_policy``,
``run_policy``, ``MetadataServer``, ``VirtualStore``, the replay drivers)
take ``device``, default ``"cuda"``, and raise without a Hopper card; pass
``device="cpu"`` to run on the CPU.
"""

from .api import (  # noqa: F401
    ApiError,
    CompleteMultipartRequest,
    CopyRequest,
    CreateBucketRequest,
    CreateMultipartRequest,
    DeleteBucketRequest,
    DeleteObjectRequest,
    DeleteObjectsRequest,
    GetRequest,
    GetResponse,
    HeadRequest,
    HeadResponse,
    ListBucketsRequest,
    ListRequest,
    ListResponse,
    ObjectStoreAPI,
    ObjectSummary,
    PutRequest,
    PutResponse,
    UploadPartRequest,
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
from .ledger import CostLedger, CostReport  # noqa: F401
from .oracle import TraceOracle  # noqa: F401
from .policies import Policy, make_policy  # noqa: F401
# replay is not imported here, so that `python -m repro_torch.core.replay`
# stays runpy-clean: `from repro_torch.core.replay import replay_differential`.
from .simulator import Simulator, run_policy  # noqa: F401
from .traces import (  # noqa: F401
    TRACE_NAMES,
    WORKLOAD_KINDS,
    Trace,
    assign_two_region,
    assign_workload,
    generate_trace,
)
from .ttl_policy import (  # noqa: F401
    AdaptiveTTLController,
    choose_ttl,
    choose_ttl_with_perf_value,
    expected_cost_curve,
)
from .virtual_store import VirtualStore  # noqa: F401
from .metadata import MetadataServer  # noqa: F401
from .backends import FSBackend, InMemoryBackend, make_backends  # noqa: F401
from .workloads import (  # noqa: F401
    WORKLOAD_NAMES, make_outage_schedule, make_workload,
)
