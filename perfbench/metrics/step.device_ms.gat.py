"""``step.device_ms``, read the same way, in the GAT training cell
(PERF.md §2).

That cell's batch build shares the pace with its device step, and its
throughput spreads too widely from run to run to hold a bound, so it
reports the training's device memory peak end to end. BENCHMARK.json lists
this reading under a name of its own whose ``moves`` names that peak
(``train_peak_mem_gib``)."""
from perfbench import harness


def read(rec):
    return harness.read_metric("step.device_ms", rec)
