"""Data-loading layer: the async subgraph pipeline."""
from repro_torch.data.prefetch import Prefetcher, SubgraphPipeline

__all__ = ["Prefetcher", "SubgraphPipeline"]
