from .engine import Request, ServeEngine
from .frontend import (QueryFrontend, QueryRecord, ServingReport,
                       TenantQuota, roofline_epoch_cost, run_closed_loop)

__all__ = [
    "Request", "ServeEngine",
    "QueryFrontend", "QueryRecord", "ServingReport", "TenantQuota",
    "roofline_epoch_cost", "run_closed_loop",
]
