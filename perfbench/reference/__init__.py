"""The plain reference that decides ``correct``: plain PyTorch and numpy,
f32 with TF32 off unless asked, importing nothing of the program. It works
out from the graph, the weights and the seed whatever the program derives
(partition, batches, halos, edge weights, compensation coefficients, the
historical stores) and computes LMC's step and the full-graph forward by
their equations.
"""
