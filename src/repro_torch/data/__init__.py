"""Data-loading layer: the synthetic token stream and the async subgraph
pipeline."""
from repro_torch.data.prefetch import Prefetcher, SubgraphPipeline
from repro_torch.data.tokens import TokenStream

__all__ = ["TokenStream", "Prefetcher", "SubgraphPipeline"]
