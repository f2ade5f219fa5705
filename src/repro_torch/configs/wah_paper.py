"""The paper's own workload (§4): WAH bitmap indexing — not an LM.

Kept in the registry so ``--arch wah-indexing`` selects the indexing
pipeline in examples/benchmarks."""
ARCH = "wah-indexing"

DEFAULT_N = 1 << 20        # input values
DEFAULT_CARDINALITY = 256  # distinct values
