"""The scan plane: S3 Select's WHERE clause on the card.

Counterpart of minio_tpu/scan/. A parsed Select's predicate (and its COUNT
aggregates) is compiled into a plan (plan.py), flattened into the program
of one hand-written predicate interpreter (ops/scan_program.py,
csrc/scan_eval.cu), and evaluated over fixed-shape pages of tokenized
CSV / JSON-Lines records (pager.py), through the batch former's ``scan``
verb (parallel/scheduler.py) so that concurrent Selects coalesce into one
launch. The row-by-row CPU evaluator (s3select/) stays the oracle and
answers every request the plan or the pages decline, counted by reason;
the framed event stream is the evaluator's byte for byte either way.
"""

from .engine import ScanEngine
from .plan import Decline, compile_plan

__all__ = ["ScanEngine", "Decline", "compile_plan"]
