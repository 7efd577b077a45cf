from .frontend import (QueryFrontend, QueryRecord, ServingReport,
                       TenantQuota, roofline_epoch_cost, run_closed_loop)

__all__ = [
    "QueryFrontend", "QueryRecord", "ServingReport", "TenantQuota",
    "roofline_epoch_cost", "run_closed_loop",
]
