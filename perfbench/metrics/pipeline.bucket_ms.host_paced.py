"""``pipeline.bucket_ms``, read the same way, in a host-paced training cell (PERF.md §2).

There the batch build sets the pace and the throughput spreads too widely
from run to run to hold a bound, so it is the per-layer
``train_nodes_per_s.host_paced``, and BENCHMARK.json lists this reading
under a name of its own whose ``moves`` names the cell's end-to-end
``train_peak_mem_gib``."""
from perfbench import harness


def read(rec):
    return harness.read_metric("pipeline.bucket_ms", rec)
