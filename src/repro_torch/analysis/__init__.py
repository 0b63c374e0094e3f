"""repro_torch.analysis — static analysis of the port's kernel, autograd,
sharding and queue invariants.

The port keeps the reference's invariants by conventions that would
otherwise be re-checked by hand at every change: the hand-written Hopper kernels must
wait for every ``cp.async`` before a barrier and then read their shared
memory, opt in to the dynamic shared memory they stage and size it from the
card's opt-in; the ``torch.autograd.Function``s must keep forward, backward
and saved-tensor arity matched by hand; the steps must not sync the host;
the threaded tiers must bound their queues; and concatenations on the
DTensor path must state their placements. This package turns those audits
into machine-checked rules, with the reference's ids, names of modules and
CLI (the reference's catalog is DESIGN.md §8; this docstring is the port's):

  R001 sharded-concat    raw torch.cat/stack & co. in code a DTensor reaches
                         (src/repro_torch/{models,launch,optim,dist}),
                         outside dist/sharding.py's concat_rows
  R002 async-copy        cp.async issues without a wait after them, staged
                         shared memory read before that wait or before a
                         __syncthreads() after it, unpaired mbarrier
                         arrive/wait (CUDA sources)
  R003 smem-budget       __global__ without __launch_bounds__, static
                         __shared__ over 48 KiB, extern __shared__ launched
                         without the cudaFuncSetAttribute opt-in or over
                         the H100's 232,448 B, a Python load of a slab-sized
                         entry point whose size is not derived from
                         build.slab_cols(…, smem_optin(…))
  R004 hot-path-hazards  host syncs (.item/.tolist/.cpu/.numpy,
                         torch.cuda.synchronize) and Python branches or
                         casts on parameters inside autograd Functions, the
                         step closures of the make_*_step factories and
                         functions handed to torch.func.vjp/checkpoint
  R005 autograd-arity    autograd.Function input count vs setup_context's
                         unpack and backward's returned gradients,
                         setup_context's signature, save_for_backward vs
                         ctx.saved_tensors unpacks, backward's cotangents vs
                         forward's outputs
  R006 unbounded-queue   unbounded queue.Queue construction and blocking
                         get/put/join without timeout= in the threaded tiers
                         (src/repro_torch/{data,serve} only)

Known-good exceptions are annotated in source with a pragma naming the rules
and the reason, ``lint: ok(R00x[,R00y]) <reason>``, in a ``#`` comment in
Python and a ``//`` comment in CUDA — the reason is mandatory; a reasonless
pragma does not suppress and is itself reported (R000). The pass runs
self-hosted over the port as a tier-1 test (zero unsuppressed findings) and
as a phase of ``chip_smoke.py``:

    python -m repro_torch.analysis [paths] [--rule R00x] [--json]
                                   [--show-suppressed]

Without paths it reads ``src/repro_torch`` and ``chip_smoke.py``. This
package imports neither JAX nor anything of ``repro``.
"""
from repro_torch.analysis.engine import (Finding, Rule, all_rules,
                                         analyze_source, run_analysis,
                                         summarize)

__all__ = ["Finding", "Rule", "all_rules", "analyze_source", "run_analysis",
           "summarize"]
