"""Session-level API (torch): config + SQL -> executable query.

Counterpart of the JAX package's `api.py`: a SessionConfig carrying the
join strategy, `target_partitions` and `replacement_required`, and a
SessionContext that registers tables with optional Statistics and plans
SQL with the copied parser, planner and optimizer. The session's tables
live on one device, the card unless the caller names another
(`device="cpu"` runs the plain versions of the kernels, as the tests do);
a query whose biggest scan passes the out-of-core thresholds streams or
grace-partitions it (runtime/executor.py). Every join runs under the
config's strategy (CSR, SORT or OA). Multi-device execution and parquet
registration raise NotImplementedError naming their ROADMAP items.
"""

from __future__ import annotations

from typing import Optional

import torch

from .models.planner import Planner
from .models.sql_parser import parse_sql
from .ops.hash_table import JoinStrategy
from .runtime.executor import QueryHandle
from .utils.catalog import Catalog, Statistics
from .utils.columnar import HostTable


class SessionConfig:
    """The JAX package's SessionConfig, less its distributed settings
    (broadcast_threshold, skew_salting, skew_factor, skew_threshold,
    distributed_staged): they steer execution across several devices, and
    passing any of them raises, as target_partitions > 1 does."""

    def __init__(self, target_partitions: int = 1,
                 join_strategy: JoinStrategy = JoinStrategy.CSR,
                 replacement_required: bool = True, **distributed):
        if distributed:
            raise NotImplementedError(f"{sorted(distributed)} steer execution on several "
                                      "devices, not ported (ROADMAP queue 1 item 13)")
        self.target_partitions = target_partitions
        self.join_strategy = join_strategy
        self.replacement_required = replacement_required


class SessionContext:
    def __init__(self, config: Optional[SessionConfig] = None, *, device="cuda"):
        self.config = config or SessionConfig()
        if self.config.target_partitions > 1:
            raise NotImplementedError("target_partitions > 1 runs on several devices, not "
                                      "ported (ROADMAP queue 1 item 13)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SessionContext: no CUDA device; pass device='cpu' to run "
                               "the kernels' plain versions on the CPU")
        self.catalog = Catalog(device=self.device)

    def register_table(self, name: str, table: HostTable,
                       statistics: Optional[Statistics] = None):
        self.catalog.register(name, table, statistics)

    def register_pydict(self, name: str, data: dict, dtypes=None,
                        statistics: Optional[Statistics] = None):
        self.register_table(name, HostTable.from_pydict(data, dtypes), statistics)

    def register_parquet(self, name: str, path: str,
                         statistics: Optional[Statistics] = None):
        raise NotImplementedError("parquet registration needs a parquet reader, not "
                                  "ported (ROADMAP queue 1 item 14)")

    def sql(self, query: str, **kernel_tables) -> QueryHandle:
        """Plan `query`; `kernel_tables` (kernels=, chain=) replace the
        kernel tables the query runs through (ops/join.py's JoinKernels,
        kernels/chain.py's ChainKernels)."""
        stmt = parse_sql(query)
        planned = Planner(self.catalog, self.config).plan(stmt)
        return QueryHandle(planned.plan, self.catalog, planned.scalar_subqueries,
                           self.config, **kernel_tables)
