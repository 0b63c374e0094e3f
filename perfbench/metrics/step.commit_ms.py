"""The store commit of a step's refreshed rows (``core/lmc.py::
commit_rows``) on the compute stream, between the CUDA events of the device
span ``step.commit``, which the trainer records while a profiler runs: the
step records' ``device_ms.commit``, median ms. The commit's boolean-mask
indexing syncs the host twice a store layer, after which the stream waits
for the host's next launches, so the span holds those gaps besides the
kernels (and, where the stream has drained before it, the host's launches
alone). Moves ``train_nodes_per_s`` where the device sets the pace."""
import statistics


def read(rec):
    if rec.get("kind") != "train":
        return None
    vals = [s["device_ms"]["commit"] for s in rec["steps"]
            if "commit" in s.get("device_ms", {})]
    return statistics.median(vals) if vals else None
