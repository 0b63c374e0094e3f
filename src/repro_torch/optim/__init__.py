"""Optimizers on parameter trees (SGD with momentum, AdamW, AdamW-8bit,
Adafactor, global-norm clip, ``make_optimizer``), gradient compression and
the LMC-SPIDER controller."""
from repro_torch.optim.compression import (TopKPayload, int8_compress,
                                           int8_decompress, topk_compress,
                                           topk_decompress)
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          adamw8bit, global_norm_clip,
                                          make_optimizer, sgd, tree_leaves,
                                          tree_map)
from repro_torch.optim.spider import SpiderState, make_spider_controller

__all__ = ["Optimizer", "make_optimizer", "sgd", "adamw", "adamw8bit",
           "adafactor", "global_norm_clip", "make_spider_controller",
           "SpiderState", "topk_compress", "topk_decompress", "TopKPayload",
           "int8_compress", "int8_decompress", "tree_map", "tree_leaves"]
