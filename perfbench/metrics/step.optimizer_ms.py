"""The optimizer's update (``optim/optimizers.py``) on the compute stream,
between the CUDA events of the device span ``step.optimizer``, which the
trainer records while a profiler runs: the step records'
``device_ms.optimizer``, median ms. Where the stream is busy with earlier
work when the update is issued, this is kernel time; where it has drained
(a host-bound cell), it is the host launching the update's kernels. Moves
``train_nodes_per_s`` where the device sets the pace."""
import statistics


def read(rec):
    if rec.get("kind") != "train":
        return None
    vals = [s["device_ms"]["optimizer"] for s in rec["steps"]
            if "optimizer" in s.get("device_ms", {})]
    return statistics.median(vals) if vals else None
