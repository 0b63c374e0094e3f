#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100 for the
recorded numbers):

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro``. Phases, each of
which raises on failure:

  1. build  — compile the CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
     sm_90a), one nvcc per source in parallel, and print the build time;
     1b. analysis — ``python -m repro_torch.analysis`` as a process over
     this tree's ``src/repro_torch`` and this file: exit 0 (no unsuppressed
     finding) and its per-rule summary; R003's shared-memory budget
     (``rules_cuda.SMEM_OPTIN_BYTES``) must equal the card's opt-in per
     block (``build.smem_optin``; on another card this fails and names
     both numbers); after phase 2, the dynamic shared memory that each
     resident kernel's launcher requested there (M * bd * element bytes,
     from the arguments its wrapper passed, ``_SlabSpy``) must fit it;
  2. kernels — each kernel against its plain PyTorch twin on the card, on the
     shapes the serving path gives it (a 100-target request on the
     arxiv-like graph: ELL buckets (3840, 8), (3840, 32), (4608, 128) over
     h (3776, 256); compensation of 3648 halo rows from a (169343, 256)
     store), with kernel / plain / library times (CUDA events, median, cold
     L2) and the least time the card could take (bytes over 3.35 TB/s),
     and the compensation's launch floor (the same kernel on 8 rows, and
     a bare 1-element fill);
     Training shapes too: the streaming SpMM and compensation at the
     full-width training batch (32 parts, 4 clusters per batch on
     arxiv-like: buckets (191744, 8), (191744, 32), (216576, 128) over h
     (191616, 256); 169344 halo rows from the (169343, 256) store), and the
     resident-source kernels at the arxiv-cpu training batch (buckets
     (3072, 8), (3072, 32), (3328, 128) over h (2880, 256); 2304 halo rows
     from a (4096, 256) store), each also bit-equal to the streaming kernel
     (the resident compensation also in every other layout, each timed), and
     a source past the shared-memory cap must raise. The SpMM kernels
     run there in their per-bucket form, one line per bucket, and then as
     the main path runs them, one whole ``bucketed_spmm`` layer (a scatter
     launch per bucket into one output) against its plain twin, against
     ``torch.sparse.mm`` on the layer's whole CSR and against its bound.
     The ELL build's two kernels (``csrc/ell_build.cu``: rows, scatter) at
     the serving batch (A) and at the training batch (A and Aᵀ), each
     against its plain twin on the card (``torch.equal``), each timed
     beside its own bytes bound, and the whole build against the numpy
     builder ``ell_from_coo`` bit for bit;
  3. serve  — GNNServer(backend="ell") on the card with a 3-layer,
     256-wide GCN over arxiv-like: ~32 requests of 1-128 targets must all
     answer exact within 1e-4 of the full-graph forward, a forced ti batch
     must answer degraded, the launch counters must show both kernels on the
     path, and drain must be clean;
  4. train  — GNNTrainer (LMC, backend="ell", streaming kernels, sgd lr 0.2)
     on the same 3x256 GCN over the whole arxiv-like graph, 32 parts, 4
     clusters per batch: the first batch's ell step must match a segment step
     on the card within the reference's bar, then 6 steps with finite losses
     and exactly 27 SpMM launches (9 forward + 2 cotangents x 3 layers x 3
     buckets over the transpose) and 5 compensation launches (3 forward + 2
     backward) and 4 ELL build launches (rows and scatter, for A and for
     Aᵀ) per step; prints host sample+build ms and step ms per step;
  5. resident — the same trainer on arxiv-cpu with stream=False for 6 steps
     on the resident-source kernels only; its losses must equal a
     stream=True run from the same seed within 1e-6 relative;
  6. supervised — the supervised trainer at phase 4's full width, with the
     async pipeline (depth 2, 2 workers: pinned host batches, the copy on a
     side stream), checkpoints every 2 steps in a temporary directory and
     the health guard (store sweep every 2 steps, the standard rho budget),
     no straggler rule. 6a: 8 steps with background checkpoint writes; the
     newest must verify; prints bytes per checkpoint, each save's hot-path
     snapshot and background crc32 + np.save times, the restore time, the
     check_store time, the pinned-memory peak, each slot's side-stream copy
     against phase 4's pageable copy, and the step time and host share
     against phase 4's. 6b: the same with synchronous checkpoints under a
     pipeline-worker crash (slot 3), a checkpoint-write failure (step 4) and
     a preemption (step 5): each recorded once, the preemption restored from
     step 2, no tmp dir left, losses equal to 6a's within rtol 1e-4. 6c:
     GraphSAGE 3x256 on ell at arxiv-cpu, a NaN batch at step 5 rolled back
     (non-finite) and the losses of an uninterrupted run within 1e-4. 6d:
     examples/train_gnn_torch.py for 100 steps, then 150 from its
     checkpoint, which must resume at step 100. Every step that runs, a
     replay or a rejected one included, must launch 27 SpMM and 5
     compensation kernels;
  7. serve faults — the serving fault matrix of tests/test_serve.py on
     phase 3's full-width server, each drill on a server of its own over a
     copy of the exact store: a slow batch (timeout, then ok), poisoned
     store rows (store-corrupt degrade, repair, exact), poisoned rows with
     the crc check off (nan-circuit, breaker open, probe, closed), a worker
     crash and crashes past the retry budget, a burst past a queue of 4,
     every row past the rho budget (ti, repair), drain. Each asserts the
     reference test's statuses and events; exact answers are held to the
     full forward within 1e-4, except the first one that reads rows a
     repair rewrote store-free (its error is printed); after a poison
     repair the repaired rows are served as targets and the drill's request
     again, both within 1e-4. Then examples/serve_gnn_torch.py --fault as a
     process (drain clean, nothing pending), and stream=False serving at
     arxiv-cpu on the resident kernels against stream=True, bit for bit;
  8. distributed — distributed LMC at phase 4's full width. 8a: two device
     batches of 4 clusters stacked into one flat batch (383,232 rows), its
     step on the card against the mean of the two per-device steps (loss
     rtol 1e-4, every gradient leaf and the h/v rows in norm rtol 2e-4),
     27 SpMM + 5 compensation launches per step, host and step ms. 8b: the
     row-sharded step over an NCCL process group of one rank (a file://
     init in a temp dir) against the plain step on the same batch: the
     committed h and v bit for bit, loss and gradients at 8a's bar. 8c:
     the step on a row × feature grid, an NCCL ``DeviceMesh`` (1, 1) over
     (data, model) in 8b's group, the stores placed by
     ``lmc_placement(features=True)`` (store rows fetched over the row
     group, their features gathered over the feature group): 27 SpMM + 5
     compensation launches per step, h and v bit for bit against 8b's
     plain step, loss and gradients at 8a's bar, step ms beside 8b's and
     the plain step's (one card cannot host two NCCL ranks: a split
     feature axis is proved by the CPU gloo tests);
  9. LM serving — the LM zoo's prefill and cached decode (no kernel of ours
     runs here; every product is a PyTorch call). 9a: llama3.2-1b at its
     published widths (16 layers, d 2048, 32 heads / 8 KV, d_ff 8192,
     vocab 128256 padded to 129024, tied embeddings), random bf16 weights
     drawn on the card from a seeded generator: prefill 4x2047 (max_seq
     2304) after a 4x2048 warm-up, the decode step at position 2047 against
     that 2048-token prefill (max rel err <= 0.02, with the two prefills'
     caches at their shared positions printed beside it), 64 greedy decode
     steps (finite logits) with ms/step, tokens/s, the bytes bound and a
     profiler split of 4 more steps; chunked attention at (1, 4096, 32, 64)
     bf16 against unchunked (<= 0.02) and a 1x4096 prefill through it; peak
     memory. 9b: deepseek-v2-lite-16b (1 dense + 2 MoE blocks; its decode
     check also with a capacity no expert can exceed, since the prefill can
     drop the last token's assignments), zamba2-1.2b whole (38 layers) and
     rwkv6-7b (2 blocks) at their published widths: prefill 2x512, decode
     against the 513-token prefill within the reference's per-family
     tolerance, 16 finite decode steps, timings. 9c: the ten reduced
     configs on the card against the port on the CPU with the same
     parameters (loss, prefill and decode logits and caches, within the
     per-family tolerance), then examples/serve_decode_torch.py as a
     process.
 10. LM training — the LM zoo's train step (``make_lm_train_step``: the
     reference's custom backward passes, remat, microbatched accumulation,
     the clipped update; again no kernel of ours, and the launch counts
     stay 0). 10a: llama3.2-1b at its published widths, not cut, remat
     "full", AdamW (lr 3e-3), 10 steps of 2x4096 tokens from
     ``TokenStream(seed=0)`` (chunked attention: 4 KV chunks of 1024, each
     rematerialized): every loss and gradient norm finite, the last loss
     below the first; step ms (median of steps 2-10), tokens/s, the share
     of the bf16 dense peak the model FLOPs reach, the AdamW update alone,
     a profiler split of one more step, peak memory. 10b: deepseek-v2-lite
     (1 dense + 2 MoE blocks), zamba2-1.2b whole (4 microbatches) and
     rwkv6-7b (2 blocks, 4 microbatches) at published widths, 3 steps of
     4x512 each, finite, step ms and peak memory; the MoE block's backward
     twice, bit for bit. 10c: one step of each of the ten reduced configs
     (its own optimizer and microbatches) on the card against the port on
     the CPU from the same parameters and batch: in f32 the loss, gradient
     norm and every new parameter leaf, in bf16 the loss and gradient
     norm, within the per-family tolerance; AdamW-8bit once. 10d:
     examples/train_lm_torch.py --steps 20 as a process, its loss falling.
 11. The LM on a device mesh (no kernel of ours; the counts stay 0). 11a:
     10a's configuration through ``launch.steps.build_cell`` on an NCCL
     ``DeviceMesh`` of one rank, (1, 1) over (data, model): parameters,
     AdamW state and batch as DTensors placed by the reference's rules, the
     activation constraints registered; 3 steps; the first loss within
     rtol 1e-4 of 10a's (bit-equality expected), the first grad norm within
     1e-3; step ms and peak memory beside 10a's. 11b:
     examples/multipod_dryrun_torch.py as three processes at once: llama3.2-1b
     train_4k on the 16x16 and 2x16x16 production meshes and 10a's
     configuration on a mesh of one, each traced on meta tensors over a
     fake process group; argument, output, peak and collective bytes,
     FLOPs and trace time per device; the predicted peak beside 11a's
     measured one, the FLOPs beside 10a's model FLOPs; and the GNN-LMC
     cell (GCNII, 16M nodes, d 512, the grid step) on 16x16 and 2x16x16 as
     two more processes, whose argument bytes a device must equal the
     reference's 3,099,953,416 (its record) and 1,554,352,392 (by hand),
     every collective kind non-zero. 11c: every kept raw ``torch.stack``
     site of the LM (models/lm.py, models/ssm.py, found by their R001
     pragmas) on this card's torch: the ten reduced archs' prefill and
     decode dry-run cells on a fake 2x2x2 CUDA mesh, each stack of
     DTensors recorded (``StackProbe``); each site must be reached, meet
     one placement and run no collective.
 12. GAT — GAT-PPI's attention kernels (``csrc/gat_attention.cu``:
     ``gat_attn_fwd``, ``gat_attn_dst`` over A, ``gat_attn_src`` over Aᵀ)
     on the ppi-like first batch of the epoch schedule (32 parts, 4
     clusters; its ELL built on the card, the padded COO's edges into row
     0 included), at the two layer shapes (4 heads × 256 concatenated, 6 ×
     121 averaged): the forward and the backward against their plain twins
     on the same card inputs (1e-5 of the largest value; ``du``, ``dv`` of
     ``|go|·|z|``), twice bit for bit, each kernel timed beside its own
     bytes bound and the forward and the backward beside
     ``perfbench/yardstick.py``'s ``attention_work`` / ``attention_vjp_work``;
     then 4 GAT-PPI steps (50 → 4×256, 4×256, 6×121, stores 1024, 1024 and
     121 wide) through GNNTrainer (LMC, ell, sgd lr 0.2): finite losses, 15
     attention launches a step in the counter and in each step's
     ``attn_launches``, no SpMM, 5 compensation and 4 ELL build launches a
     step.

Output: the card's name and power limit first; per-phase lines; then one
JSON line of per-kernel numbers (the streaming kernels at the training
shapes, the SpMM ones as a whole layer, the attention ones summed over
GAT-PPI's two layer shapes; launches summed over phases 3-8 and phase
12's training steps (the CLIs of 6d, 7, 9c, 10d and 11b run in processes
of their own and are not counted; phases 9, 10 and 11 launch none of
these kernels),
with the wrappers that launch each kernel); the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, if
CUDA is unavailable or any phase fails.
"""
from __future__ import annotations

import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
SPMM_SHAPES = ((3840, 8), (3840, 32), (4608, 128))
RESIDENT_SHAPES = ((3072, 8), (3072, 32), (3328, 128))   # arxiv-cpu, n_ext 2880
# the resident entry points' argument positions of (M, bd, bf16 source
# flag), which their launchers size the slab from: M * bd * element bytes
# (kernels/ell_spmm.py, kernels/compensate.py)
RESIDENT_ARGS = {"repro_ell_spmm_resident": (7, 10, 12),
                 "repro_lmc_compensate_resident": (7, 9, 11)}
PARTS, CLUSTERS = 32, 4          # examples/train_gnn.py defaults
HIDDEN, LAYERS = 256, 3
N_TRAIN_STEPS = 6
GAT_HIDDEN, GAT_HEADS, GAT_STEPS = 1024, (4, 6), 4   # GAT-PPI: 4x256, 6x121
N_REQUESTS = 32
REQUEST_SIZES = (1, 3, 8, 5, 12, 32, 20, 64, 100, 128, 7, 45)
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
SERVE_ATOL = 1e-4


def _time_ms(fn, reps: int = 25) -> float:
    """Median device time of ``fn`` in ms: CUDA events around each call,
    with L2 flushed before it and the stream held busy while the host
    enqueues, so host overhead is not counted."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > L2
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(2_000_000)   # ~1 ms: let the host run ahead
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _bound_ms(nbytes: float, flops: float) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def _phase_build() -> None:
    from repro_torch.kernels.build import build_kernels, library_path
    t0 = time.time()
    paths = build_kernels()
    print(f"phase 1 build: {time.time() - t0:.1f} s "
          f"{sorted(str(p.name) for p in paths.values())}")
    for name, p in paths.items():
        assert p.exists() and p == library_path(name), p


def _phase_analysis() -> None:
    """Phase 1b: the port's static analysis over this tree, and R003's
    budget against the card."""
    from repro_torch.analysis.rules_cuda import SMEM_OPTIN_BYTES
    from repro_torch.kernels.build import smem_optin
    root = Path(__file__).resolve().parent
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis",
         str(root / "src" / "repro_torch"), str(root / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert res.returncode == 0, \
        f"repro_torch.analysis exited {res.returncode}:\n{res.stdout}" \
        f"{res.stderr}"
    for line in res.stdout.strip().splitlines():
        print(f"phase 1b analysis: {line}")
    print(f"phase 1b analysis: {time.time() - t0:.2f} s as a process")
    optin = smem_optin(0)
    assert SMEM_OPTIN_BYTES == optin, (
        f"R003's shared-memory budget is {SMEM_OPTIN_BYTES} B, but this "
        f"card's opt-in per block is {optin} B")
    print(f"phase 1b R003 budget {SMEM_OPTIN_BYTES} B = smem_optin(0)")


class _SlabSpy:
    """While active, records per resident entry point the most dynamic
    shared memory a launch requested: the wrappers' ``load_kernel`` hands
    back the entry point wrapped, and each call reads M, bd and the
    element size from the arguments the wrapper passes."""

    def __enter__(self):
        self.seen: dict = {}
        self._mods = tuple(importlib.import_module(f"repro_torch.kernels.{m}")
                           for m in ("ell_spmm", "compensate"))
        self._orig = [m.load_kernel for m in self._mods]

        def spy(load):
            def load_kernel(name, symbol, argtypes):
                fn = load(name, symbol, argtypes)
                if symbol not in RESIDENT_ARGS:
                    return fn
                i_m, i_bd, i_bf16 = RESIDENT_ARGS[symbol]

                def call(*args):
                    nbytes = args[i_m] * args[i_bd] * (2 if args[i_bf16]
                                                       else 4)
                    self.seen[symbol] = max(self.seen.get(symbol, 0), nbytes)
                    return fn(*args)
                return call
            return load_kernel
        for m, orig in zip(self._mods, self._orig):
            m.load_kernel = spy(orig)
        return self

    def __exit__(self, *exc):
        for m, orig in zip(self._mods, self._orig):
            m.load_kernel = orig

    def check(self) -> None:
        """Phase 1b's last check, after phase 2: every resident kernel
        launched, each within R003's budget."""
        from repro_torch.analysis.rules_cuda import SMEM_OPTIN_BYTES
        assert set(self.seen) == set(RESIDENT_ARGS), self.seen
        for symbol, nbytes in sorted(self.seen.items()):
            assert nbytes <= SMEM_OPTIN_BYTES, (symbol, nbytes)
            print(f"phase 1b {symbol}: phase 2 requested at most {nbytes} B "
                  f"of dynamic shared memory <= budget {SMEM_OPTIN_BYTES} B")


def _spmm_case(idx, w, h, rows, num_rows: int, resident: bool = False,
               reps: int = 25):
    """Kernel vs plain vs torch.sparse on one bucket; returns numbers.

    ``rows`` are the bucket's destination rows; those equal to ``num_rows``
    are padding, whose output ``bucketed_spmm`` drops. The bound counts what
    the real data needs: the distinct h rows of the real nonzeros, their idx
    and w, and one output row per distinct real destination row (the split
    pieces of one row sum into it). ``resident`` times the resident-source
    kernel and also holds it bit for bit against the streaming one."""
    import torch
    from repro_torch.kernels.ell_spmm import (ell_spmm, ell_spmm_plain,
                                              ell_spmm_resident)
    kernel = ell_spmm_resident if resident else ell_spmm
    out_k = kernel(idx, w, h)
    out_p = ell_spmm_plain(idx, w, h)
    if resident:
        assert torch.equal(out_k, ell_spmm(idx, w, h)), \
            "resident SpMM differs from the streaming kernel"
    torch.cuda.synchronize()
    tol = TOL_F32 if h.dtype == torch.float32 else TOL_BF16
    torch.testing.assert_close(out_k.float(), out_p.float(), rtol=tol,
                               atol=tol)
    err = float((out_k.float() - out_p.float()).abs().max())
    nz = w != 0
    nnz = int(nz.sum())
    uniq = int(torch.unique(idx[nz]).numel())
    real = rows < num_rows
    out_rows = int(torch.unique(rows[real]).numel())
    d, hs = h.shape[1], h.element_size()
    nbytes = (uniq * d * hs + nnz * (4 + w.element_size())
              + out_rows * d * hs)
    crow = torch.zeros(idx.shape[0] + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(nz.sum(1), 0)
    csr = torch.sparse_csr_tensor(crow, idx[nz].long(), w[nz],
                                  size=(idx.shape[0], h.shape[0]))
    lib_out = torch.sparse.mm(csr, h)
    torch.testing.assert_close(lib_out.float(), out_p.float(), rtol=tol,
                               atol=tol)
    del out_p, lib_out
    extra = ({"stream_ms": _time_ms(lambda: ell_spmm(idx, w, h), reps)}
             if resident else {})
    return {**extra, "err": err,
            "ms": _time_ms(lambda: kernel(idx, w, h), reps),
            "plain_ms": _time_ms(lambda: ell_spmm_plain(idx, w, h), reps),
            "library_ms": _time_ms(lambda: torch.sparse.mm(csr, h), reps),
            "bound_ms": _bound_ms(nbytes, 2.0 * nnz * d), "nnz": nnz,
            "rows_real": int(real.sum()), "out_rows": out_rows}


def _comp_case(store, gids, fresh, mask, resident: bool = False,
               reps: int = 25, label: str = "",
               launch_floor: bool = False) -> dict:
    """Compensation kernel vs its plain twin (bit for bit in f32) at β = 0,
    random and 1, and timings. The bound counts the distinct store rows of
    the gids, β, mask, fresh and the whole output (masked rows must still be
    written: 0·NaN stays NaN). ``resident`` (f32 store) times the
    resident-store kernel, holds it bit for bit against the streaming one,
    and beside the wrapper's layout times every other row-share count P
    from one share per column tile to one block per SM (P = SMs // C), each
    bit-equal. ``launch_floor`` also times the kernel on the first 8 rows
    alone, and a 1-element fill: what the timing reads for a bare launch."""
    import torch
    from repro_torch.kernels.build import resident_grid, slab_cols, smem_optin
    from repro_torch.kernels.compensate import (_launch,
                                                lmc_compensate_kernel,
                                                lmc_compensate_plain,
                                                lmc_compensate_resident)
    kernel = lmc_compensate_resident if resident else lmc_compensate_kernel
    n, d = fresh.shape
    gen = torch.Generator(device="cuda").manual_seed(n)
    beta_rand = torch.rand(n, generator=gen, device="cuda")
    err = 0.0
    for beta in (torch.zeros(n, device="cuda"), beta_rand,
                 torch.ones(n, device="cuda")):
        out_k = kernel(store, gids, beta, fresh, mask)
        out_p = lmc_compensate_plain(store, gids, beta, fresh, mask)
        assert torch.equal(out_k, out_p), f"{label}: kernel != plain"
        if resident:
            assert torch.equal(out_k, lmc_compensate_kernel(
                store, gids, beta, fresh, mask)), \
                f"{label}: resident differs from the streaming kernel"
        err = max(err, float((out_k - out_p).abs().max()))
    uniq = int(torch.unique(gids).numel())
    nbytes = uniq * d * 4 + n * d * 4 + n * 12 + n * d * 4
    args = (store, gids, beta_rand, fresh, mask)
    c = {"err": err, "ms": _time_ms(lambda: kernel(*args), reps),
         "plain_ms": _time_ms(lambda: lmc_compensate_plain(*args), reps),
         "bound_ms": _bound_ms(nbytes, 5.0 * n * d), "library_ms": None}
    if resident:
        c["stream_ms"] = _time_ms(lambda: lmc_compensate_kernel(*args), reps)
        want = lmc_compensate_plain(*args)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        bd = slab_cols(store.shape[0], d, 4, smem_optin(0))
        cols, shares, rows = resident_grid(n, d, bd, 4, sms)
        others = []
        for p in range(1, max(1, sms // cols) + 1):
            r = -(-n // p)
            assert torch.equal(_launch(*args, True, block_rows=r), want), p
            ms = _time_ms(lambda: _launch(*args, True, block_rows=r), reps)
            got = -(-n // r)   # no share left empty
            others.append(f"P={got} ({cols * got} blocks of {r} rows) "
                          f"{ms:.4f} ms")
        print(f"phase 2 {label} layout: C={cols} column tiles of bd={bd}, "
              f"P={shares} row shares of {rows} rows, {cols * shares} "
              f"blocks; every P up to one block per SM: "
              + ", ".join(others))
    if launch_floor:
        few = tuple(t[:8] for t in args[1:])
        c["floor_ms"] = _time_ms(lambda: kernel(store, *few), reps)
        one = torch.empty(1, device="cuda")
        c["empty_ms"] = _time_ms(one.zero_, reps)
    print(f"phase 2 {label} N={n} store={tuple(store.shape)}: "
          f"err={err:.3g} ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
          f"bound_ms={c['bound_ms']:.5f} (no library call computes it)"
          + (f" streaming_ms={c['stream_ms']:.4f}" if resident else "")
          + (f" launch_floor_ms={c['floor_ms']:.4f} (N=8, same store;"
             f" a 1-element fill {c['empty_ms']:.4f})" if launch_floor
             else ""))
    return c


def _layer_case(label: str, ell, h, resident: bool, reps: int) -> dict:
    """One whole ``bucketed_spmm`` call (every bucket's scatter launch into
    one zeroed output, as the main path runs it) against its plain twin
    (per-bucket plain results, ``index_add_``, padding rows dropped) and
    against ``torch.sparse.mm`` on the layer's whole CSR. The bound counts
    the distinct h rows of the real nonzeros, their idx and w, and the whole
    (n, D) output written once. ``resident`` also holds the stream=False
    layer bit for bit against the streaming one. Where the layer's time
    goes: the zero fill of the output and each bucket's scatter launch,
    each timed alone."""
    import torch
    from repro_torch.kernels import bucketed_spmm
    from repro_torch.kernels.ell_spmm import (ell_spmm_resident_scatter,
                                              ell_spmm_scatter,
                                              ell_spmm_scatter_plain)
    n, (m, d) = ell.num_rows, h.shape
    stream = False if resident else None

    def plain():
        out = torch.zeros((n, d), dtype=h.dtype, device=h.device)
        for idx, w, rows, r in zip(ell.bucket_idx, ell.bucket_w,
                                   ell.bucket_rows, ell.bucket_real):
            ell_spmm_scatter_plain(idx, w, rows, h, out, r)
        return out

    got, want = bucketed_spmm(ell, h, stream=stream), plain()
    if resident:
        assert torch.equal(got, bucketed_spmm(ell, h)), \
            f"{label}: resident layer differs from the streaming one"
    torch.cuda.synchronize()
    tol = TOL_F32 if h.dtype == torch.float32 else TOL_BF16
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    err = float((got.float() - want.float()).abs().max())
    dst, src, val = [], [], []
    for idx, w, rows, r in zip(ell.bucket_idx, ell.bucket_w, ell.bucket_rows,
                               ell.bucket_real):
        nz = w[:r] != 0
        dst.append(rows[:r].long()[:, None].expand_as(nz)[nz])
        src.append(idx[:r].long()[nz])
        val.append(w[:r][nz])
    src = torch.cat(src)
    csr = torch.sparse_coo_tensor(
        torch.stack([torch.cat(dst), src]), torch.cat(val).to(h.dtype),
        (n, m)).coalesce().to_sparse_csr()
    lib = torch.sparse.mm(csr, h)
    torch.testing.assert_close(lib.float(), want.float(), rtol=tol, atol=tol)
    del got, want, lib
    nnz, hs = int(src.numel()), h.element_size()
    nbytes = (int(torch.unique(src).numel()) * d * hs + nnz * (4 + 4)
              + n * d * hs)
    c = {"err": err,
         "ms": _time_ms(lambda: bucketed_spmm(ell, h, stream=stream), reps),
         "plain_ms": _time_ms(plain, reps),
         "library_ms": _time_ms(lambda: torch.sparse.mm(csr, h), reps),
         "bound_ms": _bound_ms(nbytes, 2.0 * nnz * d), "nnz": nnz}
    if resident:
        c["stream_ms"] = _time_ms(lambda: bucketed_spmm(ell, h), reps)
    scatter = ell_spmm_resident_scatter if resident else ell_spmm_scatter
    out = torch.zeros((n, d), dtype=h.dtype, device=h.device)
    parts = [_time_ms(lambda: torch.zeros((n, d), dtype=h.dtype,
                                          device=h.device), reps)]
    for idx, w, rows, r in zip(ell.bucket_idx, ell.bucket_w, ell.bucket_rows,
                               ell.bucket_real):
        parts.append(_time_ms(lambda: scatter(idx, w, rows, h, out, r), reps))
    del out
    print(f"phase 2 {label}, whole layer's parts, each alone: zero fill "
          f"{parts[0]:.4f} ms; scatter launches "
          + ", ".join(f"K={i.shape[1]} {t:.4f} ms"
                      for i, t in zip(ell.bucket_idx, parts[1:])))
    print(f"phase 2 {label}, whole layer (bucketed_spmm, stream="
          f"{stream}, {len(ell.bucket_idx)} scatter launches into one "
          f"output, n={n}, nnz={nnz}): err={err:.3g} ms={c['ms']:.4f} "
          f"plain_ms={c['plain_ms']:.4f} library_ms={c['library_ms']:.4f} "
          f"(torch.sparse.mm, whole CSR) bound_ms={c['bound_ms']:.5f}"
          + (f" streaming_ms={c['stream_ms']:.4f}" if resident else ""))
    return c


def _spmm_layer(label: str, ell, h, resident: bool = False,
                reps: int = 25) -> dict:
    """One layer's buckets through ``_spmm_case`` (the per-bucket form):
    per-bucket lines and their sums; then the whole layer through
    ``_layer_case``, whose numbers it returns."""
    cases = []
    for idx, w, rows in zip(ell.bucket_idx, ell.bucket_w, ell.bucket_rows):
        c = _spmm_case(idx, w.to(h.dtype), h, rows, ell.num_rows, resident,
                       reps)
        cases.append(c)
        print(f"phase 2 {label} K={idx.shape[1]} rows={idx.shape[0]} "
              f"real_rows={c['rows_real']} out_rows={c['out_rows']} "
              f"nnz={c['nnz']}: err={c['err']:.3g} ms={c['ms']:.4f} "
              f"plain_ms={c['plain_ms']:.4f} "
              f"library_ms={c['library_ms']:.4f} "
              f"bound_ms={c['bound_ms']:.5f}"
              + (f" streaming_ms={c['stream_ms']:.4f}" if resident else ""))
    keys = ("ms", "plain_ms", "library_ms", "bound_ms") + (
        ("stream_ms",) if resident else ())
    total = {k: sum(c[k] for c in cases) for k in keys}
    total["err"] = max(c["err"] for c in cases)
    print(f"phase 2 {label}, one layer ({len(cases)} buckets): "
          f"ms={total['ms']:.4f} plain_ms={total['plain_ms']:.4f} "
          f"library_ms={total['library_ms']:.4f} "
          f"bound_ms={total['bound_ms']:.5f}"
          + (f" streaming_ms={total['stream_ms']:.4f}" if resident else ""))
    return _layer_case(label, ell, h, resident, reps)


def _phase_kernels(graph, gateway) -> None:
    """The streaming kernels at the serving shapes (a 100-target request)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    targets = np.sort(rng.choice(graph.num_nodes, 100, replace=False))
    sg, hb = gateway.build(targets)
    ell = hb.to("cuda").ell   # the gateway's plan, built on the card
    shapes = tuple(tuple(i.shape) for i in ell.bucket_idx)
    assert shapes == SPMM_SHAPES and sg.n_ext == 3776, (shapes, sg.n_ext)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        h = torch.randn((sg.n_ext, 256), generator=gen,
                        device="cuda").to(dtype)
        _spmm_layer(f"serving ell_spmm {str(dtype)[6:]}", ell, h)
    store = torch.randn((graph.num_nodes, 256), generator=gen, device="cuda")
    fresh = torch.randn((sg.n_halo, 256), generator=gen, device="cuda")
    _comp_case(store, hb.halo_gids.to("cuda"), fresh,
               hb.halo_mask.to("cuda"), label="serving lmc_compensate",
               launch_floor=True)


def _build_directions(sg, with_transpose: bool, device):
    """The inputs of the ELL build kernels for one batch, as
    ``ELLPlan.build_torch`` makes them on ``device``: per direction (A, and
    Aᵀ where planned), its label, the sorted keys, columns and weights,
    its layout and its real slot rows; and the plan."""
    import numpy as np
    import torch
    from repro_torch.kernels import plan_ell
    eb = importlib.import_module("repro_torch.kernels.ell_build")
    plan = plan_ell(sg.edge_src, sg.edge_dst, sg.n_ext,
                    with_transpose=with_transpose)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    src, dst = t(sg.edge_src, torch.int32), t(sg.edge_dst, torch.int32)
    key, order = torch.sort(dst, stable=True)
    col, w = src[order], t(sg.edge_w, torch.float32)[order]
    dirs = [("A", key, col, w, plan.real)]
    if with_transpose:
        key_t, order_t = torch.sort(col, stable=True)
        dirs.append(("At", key_t, key[order_t], w[order_t], plan.t_real))
    return plan, [(d, k, c, v, eb.Layout.of(plan.buckets, plan.capacity, r),
                   sum(r)) for d, k, c, v, r in dirs]


def _build_outputs(n: int, layout, dev):
    """Fresh (rowptr, counts) and zeroed (idx, wout, rid filled with n) for
    one direction, as ``kernels.ell_build._bucket`` allocates them."""
    import torch
    nb = len(layout.widths)
    slots = sum(c * k for c, k in zip(layout.capacity, layout.widths))
    return (torch.empty(n + 1, dtype=torch.int32, device=dev),
            torch.empty(nb * n, dtype=torch.int32, device=dev),
            torch.zeros(slots, dtype=torch.int32, device=dev),
            torch.zeros(slots, dtype=torch.float32, device=dev),
            torch.full((sum(layout.capacity),), n, dtype=torch.int32,
                       device=dev))


def _build_case(label: str, sg, with_transpose: bool, reps: int = 25) -> dict:
    """The ELL build's two kernels on one batch's COO, per direction: each
    against its plain twin on the card on the same inputs (``torch.equal``
    on every output), each timed (kernel and twin) beside its own bytes
    bound; and the whole build (``ELLPlan.build``) against the numpy
    builder ``ell_from_coo`` (``torch.equal``, ``bucket_real`` included).
    Returns {kernel: numbers} summed over the directions. The bounds count
    what each kernel must move: the rows kernel reads the keys once and
    writes rowptr and the counts; the scatter reads the sorted COO, rowptr,
    the counts and their scan, and writes each edge's (idx, w) and each
    real slot row's id. The zeroing of the buckets' whole capacity is the
    wrapper's fills, outside both. No library call computes either."""
    import torch
    from repro_torch.kernels import ell_from_coo
    eb = importlib.import_module("repro_torch.kernels.ell_build")
    plan, dirs = _build_directions(sg, with_transpose, "cuda")
    n, nb = plan.num_rows, len(plan.buckets)
    before = eb.LAUNCHES
    got = plan.build(*(torch.from_numpy(a).cuda() for a in (
        sg.edge_src.astype("int32"), sg.edge_dst.astype("int32"),
        sg.edge_w.astype("float32"))))
    assert eb.LAUNCHES == before + 2 * len(dirs), eb.LAUNCHES - before
    want = ell_from_coo(sg.edge_src, sg.edge_dst, sg.edge_w, n,
                        with_transpose=with_transpose)
    for g, h in ((got, want), (got.transpose, want.transpose)):
        if h is None:
            assert g is None
            continue
        assert g.bucket_real == h.bucket_real, (g.bucket_real, h.bucket_real)
        for a, b in zip(g.bucket_idx + g.bucket_w + g.bucket_rows,
                        h.bucket_idx + h.bucket_w + h.bucket_rows,
                        strict=True):
            assert torch.equal(a.cpu(), b), f"{label}: build != numpy"
    out = {name: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "library_ms": None} for name in ("ell_rows", "ell_build")}
    for d, key, col, w, lay, real in dirs:
        e = key.shape[0]
        rp, ct, idx, wout, rid = _build_outputs(n, lay, "cuda")
        eb.ell_rows(key, rp, ct, lay)
        prp, pct, pidx, pwout, prid = _build_outputs(n, lay, "cuda")
        eb.ell_rows_plain(key, prp, pct, lay)
        assert torch.equal(rp, prp) and torch.equal(ct, pct), \
            f"{label} {d}: ell_rows kernel != plain"
        incl = ct.cumsum(0, dtype=torch.int32)
        scatter = (key, col, w, rp, ct, incl)
        eb.ell_scatter(*scatter, idx, wout, rid, lay)
        eb.ell_scatter_plain(*scatter, pidx, pwout, prid, lay)
        for a, b in ((idx, pidx), (wout, pwout), (rid, prid)):
            assert torch.equal(a, b), f"{label} {d}: ell_scatter != plain"
        rows_bytes = 4 * e + 4 * (n + 1) + 4 * nb * n
        scatter_bytes = 12 * e + 4 * (n + 1) + 8 * nb * n + 8 * e + 4 * real
        cases = {
            "ell_rows": (lambda: eb.ell_rows(key, rp, ct, lay),
                         lambda: eb.ell_rows_plain(key, prp, pct, lay),
                         rows_bytes),
            "ell_build": (lambda: eb.ell_scatter(*scatter, idx, wout, rid,
                                                 lay),
                          lambda: eb.ell_scatter_plain(*scatter, pidx, pwout,
                                                       prid, lay),
                          scatter_bytes)}
        for name, (kernel, plain, nbytes) in cases.items():
            c = {"ms": _time_ms(kernel, reps),
                 "plain_ms": _time_ms(plain, reps),
                 "bound_ms": _bound_ms(nbytes, 0.0)}
            print(f"phase 2 {label} {name} ({d}: E={e} n={n} buckets "
                  f"{tuple(zip(lay.capacity, lay.widths))}): err=0 "
                  f"(torch.equal) ms={c['ms']:.4f} plain_ms="
                  f"{c['plain_ms']:.4f} (the twin on the card) bound_ms="
                  f"{c['bound_ms']:.5f} ({nbytes / 1e9:.4f} GB; no library "
                  f"call computes it)")
            for k in c:
                out[name][k] += c[k]
    print(f"phase 2 {label}: the card's build of "
          f"{'A and its transpose' if with_transpose else 'A'} equals the "
          f"numpy builder's bit for bit (bucket_real {got.bucket_real}"
          + (f", {got.transpose.bucket_real}" if with_transpose else "")
          + f"), {2 * len(dirs)} launches")
    return out


def _phase_build_kernels(graph, gateway, sampler) -> dict:
    """The ELL build kernels at the serving batch (a 100-target request, A
    only) and at the arxiv-like first training batch (A and Aᵀ); returns
    the training batch's numbers."""
    import numpy as np
    rng = np.random.default_rng(0)
    targets = np.sort(rng.choice(graph.num_nodes, 100, replace=False))
    sg, _ = gateway.build(targets)
    _build_case("serving ell build", sg, with_transpose=False)
    sg = sampler.build_batch(sampler.clusters_at(0))
    return _build_case("train ell build", sg, with_transpose=True, reps=5)


def _train_batch(sampler):
    """The training batch of schedule slot 0 (pure: the sampler's own RNG
    does not move), as a Batch on the card with the bucketed A and Aᵀ."""
    from repro_torch.core import host_batch
    sg = sampler.build_batch(sampler.clusters_at(0))
    return sg, host_batch(sg, backend="ell").to("cuda")


def _phase_train_kernels(big_sampler, small_sampler) -> dict:
    """The streaming kernels at the full-width training batch and the
    resident kernels at the arxiv-cpu one; the resident cap."""
    import torch
    from repro_torch.kernels.ell_spmm import ell_spmm_resident
    from repro_torch.kernels.compensate import lmc_compensate_resident
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, sampler, resident, reps in (
            ("ell_spmm", big_sampler, False, 5),
            ("ell_spmm_resident", small_sampler, True, 25)):
        sg, batch = _train_batch(sampler)
        shapes = tuple(tuple(i.shape) for i in batch.ell.bucket_idx)
        print(f"phase 2 training batch for {name}: pads (batch, halo, "
              f"edges) = ({sampler.pad_batch}, {sampler.pad_halo}, "
              f"{sampler.pad_edges}), ELL buckets {shapes} over h "
              f"({sg.n_ext}, {HIDDEN}); real batch/halo/edges "
              f"{sg.n_batch_real}/{sg.n_halo_real}/{sg.n_edges_real}")
        if resident:
            assert shapes == RESIDENT_SHAPES and sg.n_ext == 2880, shapes
        h = torch.randn((sg.n_ext, HIDDEN), generator=gen, device="cuda")
        out[name] = _spmm_layer(f"train {name} f32", batch.ell, h, resident,
                                reps)
        del h
        store = torch.randn((sampler.graph.num_nodes, HIDDEN), generator=gen,
                            device="cuda")
        fresh = torch.randn((sg.n_halo, HIDDEN), generator=gen,
                            device="cuda")
        comp = name.replace("ell_spmm", "lmc_compensate")
        out[comp] = _comp_case(store, batch.halo_gids, fresh,
                               batch.halo_mask, resident, reps,
                               f"train {comp}")
        del store, fresh, batch
        torch.cuda.empty_cache()
    # past the cap: one 16-byte vector per row no longer fits a block
    too_big = torch.zeros((20000, 64), device="cuda")
    idx = torch.zeros((4, 8), dtype=torch.int32, device="cuda")
    for fn, args in ((ell_spmm_resident,
                      (idx, torch.ones((4, 8), device="cuda"), too_big)),
                     (lmc_compensate_resident,
                      (too_big, torch.zeros(4, dtype=torch.int32,
                                            device="cuda"),
                       torch.ones(4, device="cuda"),
                       torch.ones((4, 64), device="cuda"),
                       torch.ones(4, device="cuda")))):
        try:
            fn(*args)
        except ValueError as e:
            assert "does not fit" in str(e), e
            print(f"phase 2 {fn.__name__} refuses M=20000: {e}")
        else:
            raise AssertionError(f"{fn.__name__} took a source past the "
                                 "shared-memory cap")
    return out


def _phase_slice(graph, gateway) -> tuple:
    """Phase 3; returns its launches and, for phase 7, the served model:
    (gnn, params, data on the card, full-graph logits)."""
    import numpy as np
    import torch
    from repro_torch.core import from_graph, make_infer_step
    from repro_torch.models import make_gnn
    from repro_torch.serve import GNNServer, ServeConfig, warm_store

    gnn = make_gnn("gcn", graph.feature_dim, 256, graph.num_classes, 3,
                   generator=torch.Generator().manual_seed(0)).cuda()
    params = gnn.params()
    t0 = time.time()
    data = from_graph(graph)
    store = warm_store(gnn, params, data)
    with torch.no_grad():
        full = gnn.full_forward(params, data.x, data.edges,
                                data.self_w).cpu().numpy()
    print(f"phase 3 warm store {tuple(store.h.shape)} + full forward: "
          f"{time.time() - t0:.1f} s")
    t0 = time.time()
    srv = GNNServer(gnn, graph, params, store=store, data=data,
                    config=ServeConfig(backend="ell", return_logits=True,
                                       default_deadline_s=60.0, warmup=True),
                    device="cuda")
    print(f"phase 3 server start (crc ledger + warm-up): "
          f"{time.time() - t0:.1f} s")
    rng = np.random.default_rng(1)
    try:
        _zero_counts()
        responses = []
        for i in range(N_REQUESTS):
            k = REQUEST_SIZES[i % len(REQUEST_SIZES)]
            nodes = rng.choice(graph.num_nodes, k, replace=False)
            r = srv.infer(nodes, request_id=f"r{i}")
            assert r.status == "ok" and r.mode == "exact", (i, r)
            np.testing.assert_allclose(r.logits, full[nodes], rtol=0,
                                       atol=SERVE_ATOL)
            assert (r.classes == full[nodes].argmax(-1)).all(), i
            responses.append((gateway.bucket_for(k), r))
        srv.config.force_mode = "ti"
        r_ti = srv.infer(rng.choice(graph.num_nodes, 50, replace=False))
        counts = _read_counts()
        ell_builds = _build_launches()
        spmm_n, comp_n = counts["ell_spmm"], counts["lmc_compensate"]
        assert r_ti.status == "degraded" and r_ti.mode == "ti", r_ti
    finally:
        drained = srv.drain(timeout=120.0)
    assert drained and srv.stats()["pending"] == 0, srv.stats()
    by_bucket = {b: [1e3 * r.latency_s for bb, r in responses if bb == b]
                 for b in gateway.buckets}
    assert all(by_bucket.values()), "a pad bucket got no request"
    responses = [r for _, r in responses]
    exact_batches = len({r.batch_seq for r in responses})
    print(f"phase 3 launches: ell_spmm={spmm_n} lmc_compensate={comp_n} "
          f"over {exact_batches} exact batches + 1 ti batch")
    # a bucket with no real row launches nothing; every batch has real rows
    # in at least one bucket per layer
    assert spmm_n >= LAYERS * (exact_batches + 1), spmm_n
    assert comp_n >= 3 * exact_batches, comp_n
    # each batch's A built on the card: one pair of launches
    print(f"phase 3 ELL build launches: {ell_builds}")
    assert ell_builds["ell_build"] >= exact_batches + 1, ell_builds
    lat = sorted(1e3 * r.latency_s for r in responses)
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]
    print(f"phase 3 served {len(responses)} requests exact, max |logit err| "
          f"<= {SERVE_ATOL}; latency p50={statistics.median(lat):.2f} ms "
          f"p99={p99:.2f} ms (of {len(lat)} sequential requests, so the "
          f"max); ti batch degraded; drain clean")

    # where a request's time goes, per pad bucket: the host batch build and
    # the exact step (host launches + device, synchronised), next to the
    # served requests' median latency (which adds the crc checks, commit,
    # queueing and copies)
    step = make_infer_step(gnn, graph.num_nodes, backend="ell",
                           fwd_mode="historical", compensation="store")
    for b in gateway.buckets:
        nodes = rng.choice(graph.num_nodes, b, replace=False)
        builds, steps = [], []
        for _ in range(7):
            t0 = time.perf_counter()
            _, hb = gateway.build(nodes)
            builds.append(time.perf_counter() - t0)
            batch = hb.to("cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = step(params, srv.store, batch, data.x, data.self_w)
            logits.cpu()
            steps.append(time.perf_counter() - t0)
        print(f"phase 3 bucket {b}: build_ms="
              f"{1e3 * statistics.median(builds):.2f} step_ms="
              f"{1e3 * statistics.median(steps):.2f} request_p50_ms="
              f"{statistics.median(by_bucket[b]):.2f} "
              f"({len(by_bucket[b])} requests)")
    return ({"ell_spmm": spmm_n, "lmc_compensate": comp_n,
             **ell_builds},
            (gnn, params, data, full))


def _counters() -> tuple:
    # the modules themselves: the package re-exports a function as ell_spmm
    return (importlib.import_module("repro_torch.kernels.ell_spmm"),
            importlib.import_module("repro_torch.kernels.compensate"))


def _zero_counts() -> None:
    for mod in _counters():
        mod.LAUNCHES = mod.LAUNCHES_RESIDENT = 0
    importlib.import_module("repro_torch.kernels.ell_build").LAUNCHES = 0


def _build_launches() -> dict:
    """The ELL build's launches since ``_zero_counts``, per kernel: its
    counter counts both, and the build launches them in pairs, the rows
    kernel then the scatter, one pair a direction."""
    n = importlib.import_module("repro_torch.kernels.ell_build").LAUNCHES
    assert n % 2 == 0, n
    return {"ell_rows": n // 2, "ell_build": n // 2}


def _read_counts() -> dict:
    spmm_mod, comp_mod = _counters()
    return {"ell_spmm": spmm_mod.LAUNCHES,
            "ell_spmm_resident": spmm_mod.LAUNCHES_RESIDENT,
            "lmc_compensate": comp_mod.LAUNCHES,
            "lmc_compensate_resident": comp_mod.LAUNCHES_RESIDENT}


def _gcn(graph):
    import torch
    from repro_torch.models import make_gnn
    return make_gnn("gcn", graph.feature_dim, HIDDEN, graph.num_classes,
                    LAYERS, generator=torch.Generator().manual_seed(0))


def _per_step_launches(buckets: int = 3) -> tuple:
    """(SpMM, compensation) launches of one LMC step: every layer's buckets
    in the forward and again over Aᵀ for each of the two cotangents; one
    compensation per layer forward and per adjoint of layers L-1..1."""
    return LAYERS * buckets * 3, LAYERS + (LAYERS - 1)


def _named(tree, path: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _named(tree[key], f"{path}.{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _named(sub, f"{path}[{i}]").items()}
    return {path.lstrip("."): tree}


def _norm_rel(a, b) -> float:
    """|a - b| / |b| in the 2-norm: the per-leaf bar of the SpMM's atomics
    (ROADMAP C.2)."""
    import torch
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))


def _check_ell_matches_segment(gnn, graph, sampler) -> None:
    """The trainer's first batch through an ell step and a segment step
    (plain gather + index_add_) on the card, from one random store.

    The loss must meet the reference's bar (rtol 1e-4,
    tests/test_ell_backend.py). Every gradient leaf and the h and v rows
    must meet its rtol of 2e-4 as a vector (|a - b| / |b| in the 2-norm).
    Elements outside the reference's elementwise bar (rtol 2e-4, atol
    1e-6) are counted and printed beside a control, two segment steps
    against each other (their index_add_ atomics sum in different orders):
    at 191,616 rows a difference in the last bit can move a near-zero
    pre-activation across the relu and one row's share of a gradient
    element with it."""
    import torch
    from repro_torch.core.history import stacked
    from repro_torch.core import (LMC, HistoricalState, from_graph,
                                  host_batch, make_train_step)
    from repro_torch.optim import tree_map
    state = sampler.state_dict()
    sg = sampler.sample()
    sampler.load_state_dict(state)   # the trainer draws this batch first
    data = from_graph(graph, device="cuda")
    params = tree_map(lambda t: t.detach().cuda(), gnn.params())
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = graph.num_nodes
    store = HistoricalState(
        h=torch.randn((LAYERS, n, HIDDEN), generator=gen, device="cuda"),
        v=1e-3 * torch.randn((LAYERS - 1, n, HIDDEN), generator=gen,
                             device="cuda"))
    runs = []
    for backend in ("segment", "segment", "ell"):
        batch = host_batch(sg, backend=backend).to("cuda")
        loss, grads, rows, _ = make_train_step(gnn, LMC, n, backend=backend)(
            params, store, batch, data.x, data.self_w)
        runs.append((loss, {**_named(grads, "grad"),
                            "h rows": stacked(rows.h),
                            "v rows": stacked(rows.v)}))
    (l_s, seg), (_, seg2), (l_e, ell) = runs
    torch.testing.assert_close(l_e, l_s, rtol=1e-4, atol=0)

    def outside(a, b):
        return int(((a - b).abs() > 1e-6 + 2e-4 * b.abs()).sum())

    worst = 0.0
    for name, b in seg.items():
        a = ell[name]
        rel = _norm_rel(a, b)
        worst = max(worst, rel)
        n_out, n_ctl = outside(a, b), outside(seg2[name], b)
        if n_out or n_ctl:
            print(f"phase 4   {name}: {n_out} of {b.numel()} elements "
                  f"outside rtol 2e-4/atol 1e-6 (control segment vs "
                  f"segment: {n_ctl}); max |err| "
                  f"{float((a - b).abs().max()):.3g}; norm rel err "
                  f"{rel:.3g}")
        assert rel <= 2e-4, (name, rel)
    print(f"phase 4 first batch, ell vs segment step on the card: loss "
          f"{float(l_e):.6f} vs {float(l_s):.6f}; worst norm rel err over "
          f"{len(seg)} grad leaves and the h/v rows {worst:.3g} (<= 2e-4)")


def _device_events(prof) -> dict:
    """{name: (ms, count)} of a torch.profiler run's device-side events
    (kernels, copies) only: a CPU op's device time repeats the time of the
    kernels it launched."""
    import torch
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms, n = out.get(e.key, (0.0, 0))
        out[e.key] = (ms + us / 1e3, n + e.count)
    return out


def _step_breakdown(tr, sampler) -> float:
    """Where a full-width step's time goes, on one more batch (slot 1 of the
    schedule, outside the counted run): the host build, the batch copy to
    the card, the train step and the optimizer, each synchronised; then one
    step under torch.profiler for the device time by kernel. Returns the
    batch copy's ms (pageable memory, the synchronous trainer's copy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import host_batch

    def timed(fn, reps=3):
        out, times = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return out, statistics.median(times)

    sg = sampler.build_batch(sampler.clusters_at(1))
    hb, host_ms = timed(lambda: host_batch(sg, backend="ell"), 1)
    batch, copy_ms = timed(lambda: hb.to("cuda"))
    args = (tr.params, tr.store, batch, tr.data.x, tr.data.self_w)
    (_, grads, _, _), step_ms = timed(lambda: tr._step(*args))
    _, opt_ms = timed(lambda: tr.opt.update(grads, tr.opt_state, tr.params,
                                            tr.lr))
    print(f"phase 4 breakdown of one step (medians of 3, synchronised): "
          f"host build {host_ms:.1f} ms, batch copy to the card and its "
          f"ELL build there {copy_ms:.1f} ms, train step {step_ms:.1f} "
          f"ms, optimizer {opt_ms:.1f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr._step(*args)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {k: ms for k, (ms, _) in _device_events(prof).items()
               if ms > 0}
    if not by_name:
        print("phase 4 profiler: no device time recorded (device busy "
              "share not measured)")
        return copy_ms
    total = sum(by_name.values())
    spmm = sum(v for k, v in by_name.items() if "ell_spmm" in k)
    comp = sum(v for k, v in by_name.items() if "compensate" in k)
    index_add = sum(v for k, v in by_name.items() if "indexFunc" in k)
    fill = sum(v for k, v in by_name.items() if "Fill" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"phase 4 profiler, one train step: wall {wall_ms:.1f} ms, device "
          f"time {total:.1f} ms (busy share {total / wall_ms:.3f}); "
          f"ell_spmm kernels {spmm:.2f} ms, compensation kernels "
          f"{comp:.2f} ms, index_add_ {index_add:.2f} ms, zero fills "
          f"{fill:.2f} ms; top: "
          + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top))
    return copy_ms


def _phase_train(graph, sampler) -> tuple:
    """LMC training at full width on the streaming kernels. Returns the
    launch counts and, for phase 6, the step and host-share medians and the
    pageable batch copy's ms."""
    import math
    from repro_torch.core import LMC
    from repro_torch.optim import sgd
    from repro_torch.train import GNNTrainer
    gnn = _gcn(graph)
    _check_ell_matches_segment(gnn, graph, sampler)
    t0 = time.time()
    tr = GNNTrainer(gnn, LMC, graph, sampler, sgd(lr=0.2), backend="ell",
                    device="cuda")
    print(f"phase 4 trainer start (graph data + stores on the card): "
          f"{time.time() - t0:.1f} s")
    _zero_counts()
    tr.run(N_TRAIN_STEPS)
    counts = _read_counts()
    for r in tr.history:
        print(f"phase 4 step {r['step']}: loss={r['loss']:.6f} "
              f"train_acc={r['train_acc']:.4f} "
              f"host_sample_build_ms={1e3 * r['host_s']:.1f} "
              f"step_ms={1e3 * (r['time_s'] - r['host_s']):.1f} "
              f"total_ms={1e3 * r['time_s']:.1f}")
    assert all(math.isfinite(r["loss"]) for r in tr.history), tr.history
    spmm, comp = _per_step_launches()
    print(f"phase 4 launches over {N_TRAIN_STEPS} steps: {counts} "
          f"(per step: ell_spmm {spmm} = {LAYERS * 3} forward + "
          f"{2 * LAYERS * 3} over the transpose; lmc_compensate {comp} = "
          f"{LAYERS} forward + {LAYERS - 1} backward)")
    assert counts == {"ell_spmm": spmm * N_TRAIN_STEPS,
                      "ell_spmm_resident": 0,
                      "lmc_compensate": comp * N_TRAIN_STEPS,
                      "lmc_compensate_resident": 0}, counts
    # every step's fresh batch: A and Aᵀ built on the card, 4 launches
    builds = _build_launches()
    print(f"phase 4 ELL build launches over {N_TRAIN_STEPS} fresh batches: "
          f"{builds} (4 a batch: rows and scatter for A and for Aᵀ)")
    assert builds == {"ell_rows": 2 * N_TRAIN_STEPS,
                      "ell_build": 2 * N_TRAIN_STEPS}, builds
    counts = {**counts, **builds}
    host = [r["host_s"] / r["time_s"] for r in tr.history[1:]]
    print(f"phase 4 host share of a step (device idle while the host samples "
          f"and builds; a ratio of timings, steps 2-{N_TRAIN_STEPS}): "
          f"{statistics.median(host):.3f}")
    copy_ms = _step_breakdown(tr, sampler)
    return counts, {**_mean_step(tr.history[1:]), "copy_ms": copy_ms}


def _mean_step(recs) -> dict:
    """Mean step ms and the share of all step time spent obtaining batches
    (sums over the steps: a pipeline's steps alternate between waiting and
    not, so a median would hide the wait)."""
    total = sum(r["time_s"] for r in recs)
    return {"step_ms": 1e3 * total / len(recs),
            "host_share": sum(r["host_s"] for r in recs) / total}


def _phase_resident(graph, parts) -> dict:
    """The same trainer on arxiv-cpu on the resident-source kernels, against
    a streaming run from the same seed."""
    import numpy as np
    from repro_torch.core import LMC
    from repro_torch.graph import ClusterSampler
    from repro_torch.optim import sgd
    from repro_torch.train import GNNTrainer
    losses, counts = {}, None
    for stream in (False, True):
        sampler = ClusterSampler(graph, PARTS, CLUSTERS, parts=parts, seed=1)
        tr = GNNTrainer(_gcn(graph), LMC, graph, sampler, sgd(lr=0.2),
                        backend="ell", stream=stream, device="cuda")
        if stream is False:
            _zero_counts()
        tr.run(N_TRAIN_STEPS)
        if stream is False:
            counts = _read_counts()
        losses[stream] = [r["loss"] for r in tr.history]
        steps = [1e3 * (r["time_s"] - r["host_s"]) for r in tr.history[1:]]
        print(f"phase 5 stream={stream}: losses "
              f"{[round(x, 6) for x in losses[stream]]}; step_ms median "
              f"{statistics.median(steps):.2f}")
    spmm, comp = _per_step_launches()
    print(f"phase 5 launches of the stream=False run: {counts}")
    assert counts == {"ell_spmm": 0, "ell_spmm_resident": spmm * N_TRAIN_STEPS,
                      "lmc_compensate": 0,
                      "lmc_compensate_resident": comp * N_TRAIN_STEPS}, counts
    np.testing.assert_allclose(losses[False], losses[True], rtol=1e-6, atol=0)
    print("phase 5 resident losses equal the streaming run's within 1e-6 "
          "relative")
    return counts


def _losses(tr) -> dict:
    """step -> loss, the last record per step (a replay overwrites)."""
    return {r["step"]: r["loss"] for r in tr.history if "loss" in r}


def _events(tr, kind: str) -> list:
    return [r for r in tr.history if r.get("event") == kind]


def _assert_launches(label: str, tr, counts: dict,
                     executed: Optional[int] = None) -> int:
    """27 SpMM and 5 compensation launches per executed step: every step
    with a loss record, a replay included, and every step rejected by the
    health gate after it ran (of trainer ``tr``; or ``executed`` steps)."""
    if executed is None:
        executed = (sum("loss" in r for r in tr.history)
                    + len(_events(tr, "health-rollback"))
                    + len(_events(tr, "health-skip-batch")))
    spmm, comp = _per_step_launches()
    print(f"phase {label} launches over {executed} executed steps: {counts}")
    assert counts == {"ell_spmm": spmm * executed, "ell_spmm_resident": 0,
                      "lmc_compensate": comp * executed,
                      "lmc_compensate_resident": 0}, (counts, executed)
    return executed


def _supervised(graph, sampler, ckpt_dir, **kw):
    """The supervised trainer of phase 6 at full width (phase 4's model and
    data): LMC on ell, the pipeline (depth 2, 2 workers), checkpoints every
    2 steps, the health guard with a store sweep every 2 steps and the
    standard rho budget; no straggler rule, so the stream is a function of
    the step alone."""
    from repro_torch.core import LMC, RHO_BUDGET_DEFAULT
    from repro_torch.optim import sgd
    from repro_torch.train import GNNTrainer, HealthConfig
    return GNNTrainer(
        _gcn(graph), LMC, graph, sampler, sgd(lr=0.2), backend="ell",
        prefetch=2, pipeline_workers=2, ckpt_dir=str(ckpt_dir), ckpt_every=2,
        health=HealthConfig(store_check_every=2,
                            rho_budget=RHO_BUDGET_DEFAULT),
        straggler_deadline=float("inf"), device="cuda", **kw)


def _phase_supervised(graph, parts, small, small_parts, phase4) -> dict:
    """Phase 6: the supervised training tier on the card. 6a runs the
    pipelined, health-guarded trainer with async checkpoints at full width;
    6b the same under a pipeline crash, a checkpoint-write failure and a
    preemption, against 6a's losses; 6c a NaN batch rolled back on
    GraphSAGE at arxiv-cpu; 6d the training CLI and its resume."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.graph import ClusterSampler
    from repro_torch.optim import tree_leaves
    from repro_torch.train import FaultPlan
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    launches: dict = {}
    try:
        print(f"phase 6 checkpoint directory {root}: "
              f"{shutil.disk_usage(root).free / 2**30:.1f} GiB free")

        def sampler():   # phase 4's: partition seed 0, sampler seed 1
            return ClusterSampler(graph, PARTS, CLUSTERS, parts=parts, seed=1)

        # ---- 6a: uninterrupted, async checkpoints
        tr = _supervised(graph, sampler(), root / "a", async_ckpt=True)
        _zero_counts()
        tr.run(8)
        counts = _read_counts()
        copy_ms = [r["slot"]["copy_ms"] for r in tr.history
                   if "copy_ms" in r.get("slot", {})]
        pinned = tr._pipeline.pinned_peak_bytes
        nbytes = sum(t.nbytes for t in tree_leaves(tr._state_tree()))
        tr.close()
        _assert_launches("6a", tr, counts)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        base = _losses(tr)
        assert sorted(base) == list(range(1, 9)), base
        assert all(np.isfinite(list(base.values()))), base
        newest = tr.ckpt.latest_step()
        assert newest == 8 and tr.ckpt.verify(8), tr.ckpt.all_steps()
        saves = list(tr.ckpt.times)
        assert [t["step"] for t in saves] == [2, 4, 6, 8], saves
        for r in tr.history:
            if "loss" in r:
                print(f"phase 6a step {r['step']}: loss={r['loss']:.6f} "
                      f"batch_wait_ms={1e3 * r['host_s']:.1f} "
                      f"total_ms={1e3 * r['time_s']:.1f} halo_staleness="
                      f"{r['halo_staleness']}")
        mean = _mean_step([r for r in tr.history if "loss" in r][1:])
        print(f"phase 6a step: mean {mean['step_ms']:.1f} ms, host share "
              f"(time waiting for the batch over all step time) "
              f"{mean['host_share']:.3f}, steps 2-8; phase 4, synchronous, "
              f"steps 2-{N_TRAIN_STEPS}: mean {phase4['step_ms']:.1f} ms, "
              f"host share {phase4['host_share']:.3f}; rho-budget "
              f"violations recorded "
              f"{sum('staleness_violation' in r for r in tr.history)}")
        print(f"phase 6a checkpoint: {nbytes} bytes per save "
              f"({nbytes / 2**30:.3f} GiB); hot-path snapshot ms per save "
              + ", ".join(f"step {t['step']} {1e3 * t['snapshot']:.1f}"
                          for t in saves)
              + "; background write s per save (crc32 + np.save) "
              + ", ".join(f"step {t['step']} {t['crc32']:.2f} + "
                          f"{t['np_save']:.2f}" for t in saves)
              + f"; step 8 verifies")
        stats = getattr(torch.cuda, "host_memory_stats", None)
        pinned_alloc = (stats().get("allocated_bytes.peak", "not reported")
                        if stats else "not available in this torch")
        print(f"phase 6a pipeline: pinned host bytes peak {pinned} "
              f"({pinned / 2**30:.2f} GiB, the pipeline's count of pinned "
              f"batches alive; the pinned allocator's peak "
              f"{pinned_alloc}); batch copy to the card on the side "
              f"stream, ms per slot: "
              + ", ".join(f"{m:.1f}" for m in copy_ms)
              + f" (phase 4, pageable and synchronous: "
              f"{phase4['copy_ms']:.1f} ms)")
        t0 = time.perf_counter()
        assert tr.restore() and tr.step_num == 8
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check = []
        for _ in range(5):
            t0 = time.perf_counter()
            assert tr.guard.check_store(tr.store) is None
            check.append(1e3 * (time.perf_counter() - t0))
        print(f"phase 6a restore of step 8 (load, crc32, to the card): "
              f"{restore_s:.2f} s; check_store (the whole store, one "
              f"reduction and one sync) median {statistics.median(check):.2f}"
              f" ms")
        del tr
        shutil.rmtree(root / "a")

        # ---- 6b: the fault matrix, synchronous checkpoints
        plan = FaultPlan(pipeline_at=(3,), ckpt_write_at=(4,),
                         preempt_at=(5,))
        tr = _supervised(graph, sampler(), root / "b",
                         failure_injector=plan)
        _zero_counts()
        tr.run(8)
        counts = _read_counts()
        tr.close()
        _assert_launches("6b", tr, counts)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        evs = [(r["step"], r["event"]) for r in tr.history if "event" in r]
        print(f"phase 6b events: {evs}")
        assert len(_events(tr, "pipeline-fault")) == 1, evs
        assert len(_events(tr, "ckpt-write-failed")) == 1, evs
        pre = _events(tr, "preemption")
        assert len(pre) == 1 and pre[0]["restored"] and pre[0]["step"] == 2, \
            pre
        assert not list((root / "b").glob("*.tmp.*"))
        got = _losses(tr)
        assert sorted(got) == sorted(base), got
        np.testing.assert_allclose([got[k] for k in sorted(got)],
                                   [base[k] for k in sorted(base)],
                                   rtol=1e-4, atol=0)
        print(f"phase 6b losses match 6a's within rtol 1e-4 (max rel "
              f"{max(abs(got[k] - base[k]) / abs(base[k]) for k in base):.3g})"
              f"; no tmp dir left; checkpoints {tr.ckpt.all_steps()}")
        del tr
        shutil.rmtree(root / "b")

        # ---- 6c: NaN batch -> rollback, GraphSAGE on ell at arxiv-cpu
        runs = {}
        for name, plan in (("clean", None),
                           ("nan", FaultPlan(nan_batch_at=(5,)))):
            from repro_torch.core import LMC
            from repro_torch.models import make_gnn
            from repro_torch.optim import sgd
            from repro_torch.train import GNNTrainer, HealthConfig
            gnn = make_gnn("sage", small.feature_dim, HIDDEN,
                           small.num_classes, LAYERS,
                           generator=torch.Generator().manual_seed(0))
            tr = GNNTrainer(
                gnn, LMC, small, ClusterSampler(small, PARTS, CLUSTERS,
                                                parts=small_parts, seed=1),
                sgd(lr=0.2), backend="ell", ckpt_dir=str(root / name),
                ckpt_every=2, health=HealthConfig(), failure_injector=plan,
                straggler_deadline=float("inf"), device="cuda")
            _zero_counts()
            tr.run(10)
            counts = _read_counts()
            tr.close()
            _assert_launches(f"6c {name}", tr, counts)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            runs[name] = tr
        rb = _events(runs["nan"], "health-rollback")
        assert len(rb) == 1 and "non-finite" in rb[0]["reason"], rb
        assert len(_events(runs["clean"], "health-rollback")) == 0
        got, want = _losses(runs["nan"]), _losses(runs["clean"])
        assert sorted(got) == sorted(want) == list(range(1, 11)), got
        np.testing.assert_allclose([got[k] for k in sorted(got)],
                                   [want[k] for k in sorted(want)],
                                   rtol=1e-4, atol=0)
        print(f"phase 6c GraphSAGE on ell: {rb[0]['reason']} at step 5, "
              f"rolled back to step {rb[0]['step']}; losses match the "
              f"uninterrupted run within rtol 1e-4")
        del runs

        # ---- 6d: the training CLI, then its resume
        cli = Path(__file__).resolve().parent / "examples/train_gnn_torch.py"
        env = {**os.environ, "PYTHONPATH": str(cli.parent.parent / "src")}
        outs = []
        for n in (100, 150):
            t0 = time.time()
            res = subprocess.run(
                [sys.executable, str(cli), "--preset", "arxiv-cpu",
                 "--backend", "ell", "--health", "--async-ckpt", "--steps",
                 str(n), "--ckpt-dir", str(root / "cli")],
                capture_output=True, text=True, env=env, timeout=600)
            assert res.returncode == 0, res.stdout + res.stderr
            outs.append(res.stdout)
            print(f"phase 6d train_gnn_torch.py --steps {n}: "
                  f"{time.time() - t0:.1f} s; last line: "
                  f"{res.stdout.strip().splitlines()[-1]}")
        assert "resumed" not in outs[0], outs[0]
        assert "resumed from checkpoint at step 100" in outs[1], outs[1]
        print("phase 6d the second run resumed from checkpoint at step 100")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def _add(launches: dict, counts: dict) -> None:
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v


def _poisoned_gids(srv) -> list:
    """The store rows a serve-poison drill wrote NaN into (its event)."""
    ev = [e for e in srv.events if e["kind"] == "poisoned"]
    assert len(ev) == 1, srv.events
    return [int(v) for v in
            ev[0]["detail"].removeprefix("rows ").strip("[]").split(",")]


def _phase_serve_faults(graph, small, served) -> dict:
    """Phase 7: the serving fault matrix of tests/test_serve.py on the card,
    on phase 3's full-width server (3x256 GCN over arxiv-like, ell, an exact
    store), each drill on a server of its own over a copy of the store. Each
    drill asserts the reference test's statuses and events; every exact
    answer whose halo rows the store holds exactly is held to the full-graph
    forward within 1e-4. A repair rewrites rows store-free (ti-grade,
    serve/server.py ``_repair``), so the first exact answer that reads them
    is printed with its error, not held to that bar; the repaired rows are
    then served as targets (exact from exact neighbours, which rewrites
    them exactly) and the drill's request must meet the bar again. Then the
    serving CLI with its fault drills, and stream=False (the resident
    kernels) against stream=True at arxiv-cpu, logits bit for bit."""
    import numpy as np
    import torch
    from repro_torch.core import HistoricalState, from_graph
    from repro_torch.core.methods import RHO_BUDGET_DEFAULT
    from repro_torch.serve import GNNServer, ServeConfig, warm_store
    from repro_torch.train import FaultPlan
    gnn, params, data, full = served
    store = warm_store(gnn, params, data, device="cuda")
    launches: dict = {}

    def server(g, gnn_, params_, data_, store_, plan=None, **cfg):
        cfg = {"backend": "ell", "return_logits": True,
               "default_deadline_s": 60.0, **cfg}
        return GNNServer(gnn_, g, params_, store=HistoricalState(
            store_.h.clone()), config=ServeConfig(**cfg), data=data_,
            fault_plan=None if plan is None else FaultPlan(**plan),
            device="cuda")

    def show(label, r, nodes=None, bar=True):
        """Print one response; hold an exact answer to the full forward
        (``bar``) or print its error (``bar=False``)."""
        err = ""
        if nodes is not None and r.status == "ok" and r.mode == "exact":
            e = float(np.abs(r.logits - full[nodes]).max())
            err = f" max|logit err| {e:.3g}"
            if bar:
                assert e <= SERVE_ATOL, (label, e)
                err += f" (<= {SERVE_ATOL})"
            else:
                err += " (reads repaired rows: not held to 1e-4)"
        print(f"phase 7{label}: {r.status} mode={r.mode} reason="
              f"{r.degraded_reason} attempts={r.attempts} latency "
              f"{1e3 * r.latency_s:.2f} ms{err}")

    def drill(label, scenario, **kw):
        t0 = time.time()
        srv = server(graph, gnn, params, data, store, **kw)
        start = time.time() - t0
        _zero_counts()
        try:
            scenario(srv, label)
        finally:
            srv.close(drain=False, timeout=120.0)
        _add(launches, _read_counts())
        print(f"phase 7{label} events {[e['kind'] for e in srv.events]}; "
              f"stats {srv.stats()}; server start {start:.1f} s")

    def heal(srv, label, nodes):
        """Serve the repaired rows as targets, then ``nodes``: both exact
        within the bar."""
        rows = np.array(_poisoned_gids(srv))
        show(f"{label} repaired rows {rows.tolist()} as targets",
             srv.infer(rows), rows)
        show(f"{label} the drill's request again", srv.infer(nodes), nodes)

    def slow(srv, label):
        qs = [np.array([1]), np.array([2]), np.array([3])]
        rs = [srv.infer(qs[0]), srv.infer(qs[1], deadline_s=0.3),
              srv.infer(qs[2])]
        for i, (r, q) in enumerate(zip(rs, qs)):
            show(f"{label} request {i + 1}", r, q)
        assert [r.status for r in rs] == ["ok", "timeout", "ok"], rs
        assert any(e["kind"] == "slow-batch" for e in srv.events)
        st = srv.stats()
        assert st["pending"] == 0 and st["breaker"] == "closed", st

    def poison(srv, label):
        q = np.array([7, 8, 9])
        r1, r2, r3 = srv.infer(q), srv.infer(q), srv.infer(q)
        show(f"{label} request 1", r1, q)
        show(f"{label} request 2 (poisoned)", r2, q)
        show(f"{label} request 3", r3, q, bar=False)
        assert r1.status == "ok" and r1.mode == "exact"
        assert r2.status == "degraded" and r2.mode == "ti", r2
        assert "store-corrupt" in r2.degraded_reason
        assert np.isfinite(np.asarray(r2.classes)).all()
        assert r3.status == "ok" and r3.mode == "exact", r3
        assert any(e["kind"] == "repair" for e in srv.events)
        assert torch.isfinite(srv.store.h).all()
        heal(srv, label, q)

    def breaker(srv, label):
        q = np.array([4, 5, 6])
        r1 = srv.infer(q)
        r2 = srv.infer(q)
        assert srv.stats()["breaker"] == "open"
        r3, r4 = srv.infer(q), srv.infer(q)
        for i, r in enumerate((r1, r2, r3)):
            show(f"{label} request {i + 1}", r, q)
        show(f"{label} request 4 (probe)", r4, q, bar=False)
        assert r1.status == "ok"
        assert r2.status == "degraded" and r2.degraded_reason == \
            "nan-circuit", r2
        assert np.isfinite(np.asarray(r2.classes)).all()
        assert r3.status == "degraded" and r3.degraded_reason == \
            "nan-circuit-open", r3
        assert r4.status == "ok" and srv.stats()["breaker"] == "closed", r4
        kinds = {e["kind"] for e in srv.events}
        assert {"breaker-open", "breaker-closed", "repair"} <= kinds, kinds
        heal(srv, label, q)

    def crash(srv, label):
        qs = [np.array([12, 13]), np.array([14])]
        r1, r2 = srv.infer(qs[0]), srv.infer(qs[1])
        show(f"{label} request 1", r1, qs[0])
        show(f"{label} request 2", r2, qs[1])
        assert r1.status == "ok" and r1.attempts == 2, r1
        assert r2.status == "ok"
        st = srv.stats()
        assert st["worker_restarts"] == 1 and st["pending"] == 0, st

    def crash_budget(srv, label):
        qs = [np.array([20]), np.array([21]), np.array([22])]
        rs = [srv.infer(q) for q in qs]
        for i, (r, q) in enumerate(zip(rs, qs)):
            show(f"{label} request {i + 1}", r, q)
        assert rs[0].status == "error" and "retry budget" in rs[0].detail
        assert [r.status for r in rs] == ["error", "error", "ok"], rs
        assert srv.stats()["pending"] == 0

    def burst(srv, label):
        r1 = srv.infer(np.array([1]))
        show(f"{label} request 1", r1, np.array([1]))
        futs = [srv.submit(np.array([2]))]              # seq 2 stalls
        time.sleep(0.1)
        futs += [srv.submit(np.array([i])) for i in range(3, 33)]
        rs = [f.result(timeout=120.0) for f in futs]
        statuses = [r.status for r in rs]
        for i, r in enumerate(rs):
            if r.status == "ok":
                show(f"{label} burst request {i + 2}", r, np.array([i + 2]))
        last = srv.infer(np.array([40]))
        show(f"{label} after the burst", last, np.array([40]))
        print(f"phase 7{label} burst of 31 behind a stalled batch: "
              f"{statuses.count('ok')} ok, {statuses.count('overloaded')} "
              f"overloaded")
        assert statuses.count("overloaded") >= 1, statuses
        assert statuses.count("ok") >= 1, statuses
        assert set(statuses) <= {"ok", "overloaded"}, statuses
        assert last.status == "ok" and srv.stats()["pending"] == 0

    def staleness(srv, label):
        srv.notify_update(RHO_BUDGET_DEFAULT + 1)   # every row over budget
        q = np.array([10, 11])
        r1, r2 = srv.infer(q), srv.infer(q)
        show(f"{label} request 1", r1, q)
        show(f"{label} request 2", r2, q, bar=False)
        assert r1.status == "degraded" and r1.mode == "ti", r1
        assert "staleness" in r1.degraded_reason
        assert r2.status == "ok" and r2.mode == "exact", r2
        assert any(e["kind"] == "repair" for e in srv.events)

    def drain(srv, label):
        qs = [np.array([i, i + 100]) for i in range(10)]
        futs = [srv.submit(q) for q in qs]
        t0 = time.time()
        assert srv.drain(timeout=120.0)
        print(f"phase 7{label} drain of 10 in-flight requests: "
              f"{1e3 * (time.time() - t0):.1f} ms")
        for i, (f, q) in enumerate(zip(futs, qs)):
            r = f.result(timeout=1.0)
            show(f"{label} request {i + 1}", r, q)
            assert r.status == "ok", r
        assert srv.stats()["pending"] == 0

    drill("a serve_slow", slow, plan=dict(serve_slow_at=(2,),
                                          serve_slow_s=0.6))
    drill("b serve_poison", poison, plan=dict(serve_poison_at=(2,)))
    drill("c nan breaker", breaker, plan=dict(serve_poison_at=(2,)),
          verify_rows=False, breaker_cooldown=1, breaker_heal_after=1)
    drill("d serve_crash", crash, plan=dict(serve_crash_at=(1,)))
    drill("e serve_crash over budget", crash_budget,
          plan=dict(serve_crash_at=(1, 2)), max_attempts=1)
    drill("f serve_burst", burst, plan=dict(serve_slow_at=(2,),
                                            serve_slow_s=0.5), queue_depth=4)
    drill("g staleness", staleness)
    drill("h drain", drain)
    del store
    torch.cuda.empty_cache()

    cli = Path(__file__).resolve().parent / "examples/serve_gnn_torch.py"
    env = {**os.environ, "PYTHONPATH": str(cli.parent.parent / "src")}
    t0 = time.time()
    res = subprocess.run([sys.executable, str(cli), "--fault", "--requests",
                          "24", "--backend", "ell"],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    print(f"phase 7i serve_gnn_torch.py --fault --requests 24 --backend ell: "
          f"{time.time() - t0:.1f} s; "
          + "; ".join(line.strip() for line in out.splitlines()
                      if line.startswith(("status:", "server events:",
                                          "drain clean:", "latency"))))
    assert "drain clean: True" in out and "pending after drain: 0" in out, \
        out

    # stream=False (resident kernels) against stream=True at arxiv-cpu
    from repro_torch.models import make_gnn
    sgnn = make_gnn("gcn", small.feature_dim, HIDDEN, small.num_classes,
                    LAYERS, generator=torch.Generator().manual_seed(0)).cuda()
    sparams = sgnn.params()
    sdata = from_graph(small, device="cuda")
    sstore = warm_store(sgnn, sparams, sdata, device="cuda")
    with torch.no_grad():
        sfull = sgnn.full_forward(sparams, sdata.x, sdata.edges,
                                  sdata.self_w).cpu().numpy()
    rng = np.random.default_rng(3)
    reqs = [rng.choice(small.num_nodes, k, replace=False)
            for k in REQUEST_SIZES]
    logits = {}
    for stream in (True, False):
        srv = server(small, sgnn, sparams, sdata, sstore, stream=stream)
        _zero_counts()
        try:
            rs = [srv.infer(q) for q in reqs]
        finally:
            assert srv.drain(timeout=120.0)
        counts = _read_counts()
        _add(launches, counts)
        for r, q in zip(rs, reqs):
            assert r.status == "ok" and r.mode == "exact", r
            np.testing.assert_allclose(r.logits, sfull[q], rtol=0,
                                       atol=SERVE_ATOL)
        logits[stream] = [r.logits for r in rs]
        resident = counts["ell_spmm_resident"] + counts[
            "lmc_compensate_resident"]
        streaming = counts["ell_spmm"] + counts["lmc_compensate"]
        assert (resident > 0 and streaming == 0) if stream is False else \
            (streaming > 0 and resident == 0), counts
        print(f"phase 7j arxiv-cpu stream={stream}: {len(rs)} exact "
              f"answers within {SERVE_ATOL} of the full forward; launches "
              f"{counts}")
    assert all(np.array_equal(a, b) for a, b in zip(logits[False],
                                                    logits[True]))
    print("phase 7j stream=False logits equal stream=True bit for bit")
    return launches


def _phase_distributed(graph, sampler) -> dict:
    """Phase 8: distributed LMC at phase 4's full width (3x256 GCN,
    arxiv-like, 32 parts, ell, streaming kernels). 8a: two device batches
    of 4 clusters each stacked into one flat batch, its step on the card
    against the mean of the two per-device steps. 8b: the row-sharded step
    over an NCCL group of one rank (fetch_rows / route_rows on the card)
    against the plain step on the same batch."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core.history import stacked
    from repro_torch.core import (LMC, HistoricalState, commit_rows,
                                  from_graph, host_batch, make_train_step)
    from repro_torch.core.distributed import (commit_owned_rows,
                                              make_distributed_train_step,
                                              stack_batches)
    from repro_torch.dist import dp_axis_size, take_block
    from repro_torch.optim import tree_map
    launches: dict = {}
    n = graph.num_nodes
    gnn = _gcn(graph)
    params = tree_map(lambda t: t.detach().cuda(), gnn.params())
    data = from_graph(graph, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    h0 = torch.randn((LAYERS, n, HIDDEN), generator=gen, device="cuda")
    v0 = 1e-3 * torch.randn((LAYERS - 1, n, HIDDEN), generator=gen,
                            device="cuda")
    store = HistoricalState(h0, v0)   # a step reads the store, never writes
    spmm, comp = _per_step_launches()

    t0 = time.perf_counter()
    sgs = [sampler.build_batch(sampler.clusters_at(i)) for i in (0, 1)]
    sample_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    flat = stack_batches(sgs, backend="ell")
    stack_ms = 1e3 * (time.perf_counter() - t0)
    rows = flat.batch_gids.shape[0] + flat.halo_gids.shape[0]
    assert rows == 2 * sgs[0].n_ext, rows
    fb = flat.to("cuda")
    step = make_train_step(gnn, LMC, n, backend="ell")
    reps, times = 3, []
    _zero_counts()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, frows, _ = step(params, store, fb, data.x, data.self_w)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    counts = _read_counts()
    _add(launches, counts)
    assert counts == {"ell_spmm": spmm * reps, "ell_spmm_resident": 0,
                      "lmc_compensate": comp * reps,
                      "lmc_compensate_resident": 0}, counts
    del fb
    per = []
    _zero_counts()
    for sg in sgs:
        batch = host_batch(sg, backend="ell").to("cuda")
        per.append(step(params, store, batch, data.x, data.self_w))
    _add(launches, _read_counts())
    # host_batch keeps a scale as shape (1,), stack_batches as the
    # reference's shape (): compare the values
    torch.testing.assert_close(loss.reshape(()), ((per[0][0] + per[1][0])
                                                  / 2).reshape(()),
                               rtol=1e-4, atol=0)
    mean = tree_map(lambda a, b: (a + b) / 2, per[0][1], per[1][1])
    worst = 0.0
    for (name, a), b in zip(_named(grads, "grad").items(),
                            _named(mean, "grad").values()):
        worst = max(worst, _norm_rel(a, b))
        assert _norm_rel(a, b) <= 2e-4, (name, _norm_rel(a, b))
    nb = sgs[0].n_batch
    for part, r in ((slice(0, nb), per[0][2]), (slice(nb, 2 * nb),
                                                 per[1][2])):
        for got, want in ((stacked(frows.h)[:, part], stacked(r.h)),
                          (stacked(frows.v)[:, part], stacked(r.v))):
            worst = max(worst, _norm_rel(got, want))
            assert _norm_rel(got, want) <= 2e-4, _norm_rel(got, want)
    print(f"phase 8a stacked batch of 2 x {CLUSTERS} clusters: {rows} rows "
          f"({flat.edge_src.shape[0]} edges); host: sample + build of the "
          f"two subgraphs {sample_ms:.1f} ms, stack_batches with the ELL "
          f"of A and Aᵀ {stack_ms:.1f} ms; flat step on the card (median of "
          f"{reps}, synchronised) {statistics.median(times):.1f} ms; "
          f"launches {counts} ({spmm} SpMM + {comp} compensation per step); "
          f"loss {float(loss):.6f} vs the per-device mean "
          f"{float((per[0][0] + per[1][0]) / 2):.6f} (rtol 1e-4); worst "
          f"norm rel err over the grad leaves and h/v rows {worst:.3g} "
          f"(<= 2e-4)")
    del per, frows, flat, grads
    torch.cuda.empty_cache()

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_nccl_"))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'init'}",
                            world_size=1, rank=0)
    try:
        assert dp_axis_size() == 1 and dist.get_backend() == "nccl"
        batch = host_batch(sgs[0], backend="ell").to("cuda")
        plain = HistoricalState(h0.clone(), v0.clone())
        mine = HistoricalState(h0.clone(), v0.clone())
        l1, g1, r1, _ = step(params, plain, batch, data.x, data.self_w)
        commit_rows(plain, batch, r1, n)
        dstep = make_distributed_train_step(gnn, LMC, n, backend="ell")
        x_blk, sw_blk = (take_block(data.x, 0, 1, 0),
                         take_block(data.self_w, 0, 1, 0))
        # twice (a step never writes the store): the first call also sets
        # up the NCCL communicator
        _zero_counts()
        dist_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            l2, g2, owned, _ = dstep(params, mine, batch, x_blk, sw_blk)
            torch.cuda.synchronize()
            dist_ms.append(1e3 * (time.perf_counter() - t0))
        counts = _read_counts()
        _add(launches, counts)
        assert counts == {"ell_spmm": 2 * spmm, "ell_spmm_resident": 0,
                          "lmc_compensate": 2 * comp,
                          "lmc_compensate_resident": 0}, counts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, plain, batch, data.x, data.self_w)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        commit_owned_rows(mine, owned, n)
        assert torch.equal(plain.h, mine.h) and torch.equal(plain.v, mine.v)
        torch.testing.assert_close(l2, l1, rtol=1e-4, atol=0)
        worst = 0.0
        for (name, a), b in zip(_named(g2, "grad").items(),
                                _named(g1, "grad").values()):
            worst = max(worst, _norm_rel(a, b))
            assert _norm_rel(a, b) <= 2e-4, (name, _norm_rel(a, b))
        print(f"phase 8b row-sharded step over an NCCL group of 1: "
              f"{owned.gids.numel()} owned rows routed and committed, h and "
              f"v equal to the plain step's bit for bit; loss "
              f"{float(l2):.6f} vs {float(l1):.6f}; worst grad norm rel "
              f"err {worst:.3g} (<= 2e-4); step with fetch, all-reduce and "
              f"route {dist_ms[1]:.1f} ms (first call, with the NCCL "
              f"communicator's set-up, {dist_ms[0]:.1f} ms), the plain step "
              f"on the same batch {plain_ms:.1f} ms (synchronised); "
              f"launches {counts}")
        del mine, owned, g2
        torch.cuda.empty_cache()
        _grid_step(gnn, params, data, batch, h0, v0, n,
                   (l1, g1, plain), (dist_ms[1], plain_ms), launches)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _grid_step(gnn, params, data, batch, h0, v0, n, want, times,
               launches: dict) -> None:
    """Phase 8c: the step on a row × feature grid, an NCCL DeviceMesh (1, 1)
    over (data, model) in 8b's process group: the stores placed by
    ``lmc_placement(features=True)``, store rows fetched over the row
    group and gathered over the feature group, against 8b's plain step."""
    import torch
    from repro_torch.checkpoint import reshard
    from repro_torch.core import LMC, HistoricalState
    from repro_torch.core.distributed import (commit_owned_rows,
                                              make_distributed_train_step)
    from repro_torch.dist import lmc_placement
    from repro_torch.dist.mesh import grid_groups, make_mesh
    l1, g1, plain = want
    mesh = make_mesh((1, 1), ("data", "model"))
    rows, feats = grid_groups(mesh)
    whole = {"store": (h0, v0), "x": data.x, "self_w": data.self_w}
    mine = reshard(whole, lmc_placement(whole, features=True), group=rows,
                   model_group=feats, device="cuda")
    store = HistoricalState(*mine["store"])
    assert store.h.shape == h0.shape, store.h.shape
    gstep = make_distributed_train_step(gnn, LMC, n, group=rows,
                                        model_group=feats, backend="ell")
    _zero_counts()
    grid_ms = []
    for _ in range(2):   # a step never writes the store
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l3, g3, owned, _ = gstep(params, store, batch, mine["x"],
                                 mine["self_w"])
        torch.cuda.synchronize()
        grid_ms.append(1e3 * (time.perf_counter() - t0))
    counts = _read_counts()
    _add(launches, counts)
    _assert_launches("8c", None, counts, executed=2)
    commit_owned_rows(store, owned, n, group=rows)
    assert torch.equal(plain.h, store.h) and torch.equal(plain.v, store.v)
    torch.testing.assert_close(l3, l1, rtol=1e-4, atol=0)
    worst = 0.0
    for (name, a), b in zip(_named(g3, "grad").items(),
                            _named(g1, "grad").values()):
        worst = max(worst, _norm_rel(a, b))
        assert _norm_rel(a, b) <= 2e-4, (name, _norm_rel(a, b))
    print(f"phase 8c grid step on an NCCL mesh (1, 1) over (data, model): "
          f"local stores {tuple(store.h.shape)} and "
          f"{tuple(store.v.shape)}; {owned.gids.numel()} owned rows routed "
          f"and committed, h and v equal to the plain step's bit for bit; "
          f"loss {float(l3):.6f} vs {float(l1):.6f}; worst grad norm rel "
          f"err {worst:.3g} (<= 2e-4); step with fetch, feature gather, "
          f"all-reduce and route {grid_ms[1]:.1f} ms (first call "
          f"{grid_ms[0]:.1f} ms), 8b's row step {times[0]:.1f} ms, the "
          f"plain step {times[1]:.1f} ms (synchronised); one card cannot "
          f"host two NCCL ranks, so a split feature axis is proved by the "
          f"CPU gloo tests (tests/test_torch_distributed_grid.py), not here")


LM_TOL = {"moe": 0.12, "hybrid": 0.05, "default": 0.02}  # tests/test_lm_archs.py:14
LM_FULL = "llama3.2-1b"
LM_BATCH, LM_PROMPT, LM_MAX_SEQ, LM_DECODE = 4, 2047, 2304, 64
LM_CUT = (("deepseek-v2-lite-16b", {"dense_blocks": 1, "moe_blocks": 2}),
          ("zamba2-1.2b", {}),
          ("rwkv6-7b", {"blocks": 2}))
LM_CUT_BATCH, LM_CUT_PROMPT, LM_CUT_DECODE = 2, 512, 16


def _lm_tol(cfg) -> float:
    return LM_TOL.get(cfg.family, LM_TOL["default"])


def _rel_err(ref, out) -> float:
    """max |ref - out| over max |ref| (the reference tests' bf16 measure)."""
    ref, out = ref.float(), out.float().to(ref.device)
    return float((ref - out).abs().max() / ref.abs().max().clamp(min=1e-6))


def _tree_rel_err(ref: dict, out: dict) -> float:
    from repro_torch.models.spec import tree_leaves
    a, b = dict(tree_leaves(ref)), dict(tree_leaves(out))
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    return max(_rel_err(a[k], b[k]) for k in a)


def _event_ms(fn) -> tuple:
    """(fn's result, ms between CUDA events recorded before and after it):
    for an eager model call, the time the card takes to run what the host
    enqueues, host launch gaps included."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _profile_device(fn) -> tuple:
    """(wall ms, device ms, device launches, {kernel: (ms, launches)}) of
    one synchronised call of fn under torch.profiler; device ms sums the
    kernels' and copies' own times. None for the device numbers if the
    profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = _device_events(prof)
    dev_ms = sum(ms for ms, _ in events.values())
    launches = sum(n for _, n in events.values())
    if not launches:
        return wall_ms, None, None, events
    return wall_ms, dev_ms, launches, events


def _kernel_kinds(events: dict) -> dict:
    """Device ms per kind of kernel, from the kernels' names: cuBLAS and
    CUTLASS GEMMs, PyTorch's elementwise kernels, reductions (softmax,
    norms, sums), index/gather/scatter kernels, copies and fills."""
    kinds = (("gemm", ("gemm", "xmma", "cutlass", "sm90_")),
             ("elementwise", ("elementwise",)),
             ("reduce", ("reduce", "softmax", "norm")),
             ("index", ("index", "gather", "scatter")),
             ("copy/fill", ("copy", "memcpy", "memset", "fill", "cat")))
    out: dict = {}
    for name, (ms, _) in events.items():
        low = name.lower()
        kind = next((k for k, keys in kinds if any(w in low for w in keys)),
                    "other")
        out[kind] = out.get(kind, 0.0) + ms
    return out


def _nbytes(tree: dict) -> int:
    from repro_torch.models.spec import tree_leaves
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree))


def _greedy(lm, params, caches, tok, start: int, steps: int):
    """``steps`` greedy decode steps from position ``start``; returns (the
    tokens (B, steps), the last logits, whether every step's logits were
    finite, the caches)."""
    import torch
    finite = torch.ones((), dtype=torch.bool, device=tok.device)
    out, logits = [], None
    for i in range(steps):
        logits, caches = lm.decode_step(params, caches, tok, start + i)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1), logits, bool(finite), caches


def _lm_full_width() -> None:
    """Phase 9a: llama3.2-1b at its published widths on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import attention
    from repro_torch.models.lm import LM
    cfg = get_config(LM_FULL)
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, init_ms = _event_ms(lambda: lm.init_params(gen))
    pbytes = _nbytes(params)
    print(f"phase 9a {LM_FULL}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV of {cfg.dh}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab} padded to {lm.vpad}, tied "
          f"embeddings {cfg.tie_embeddings}: {pbytes} bytes of parameters "
          f"drawn on the card in {init_ms:.1f} ms")
    b, s = LM_BATCH, LM_PROMPT
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                         device="cuda")
    # the 2048-token prompt: the decode check's reference, and the warm-up
    (full, full_caches), full_ms = _event_ms(
        lambda: lm.prefill(params, toks, LM_MAX_SEQ))
    (logits, caches), prefill_ms = _event_ms(
        lambda: lm.prefill(params, toks[:, :s], LM_MAX_SEQ))
    assert logits.shape == (b, lm.vpad) and bool(torch.isfinite(logits).all())
    cache_bytes = _nbytes(caches)
    # the two prefills' caches at the positions they share: what the card's
    # bf16 rounding alone moves through 16 layers, no decode involved
    shared = max(_rel_err(full_caches["blocks"][k][:, :, :s],
                          caches["blocks"][k][:, :, :s]) for k in ("k", "v"))
    del full_caches
    (dec, caches), first_ms = _event_ms(
        lambda: lm.decode_step(params, caches, toks[:, s:], s))
    err = _rel_err(full, dec)
    print(f"phase 9a prefill {b}x{s} (max_seq {LM_MAX_SEQ}): "
          f"{prefill_ms:.1f} ms, {b * s / prefill_ms * 1e3:.0f} tokens/s "
          f"(the {b}x{s + 1} prefill before it, the warm-up: "
          f"{full_ms:.1f} ms); caches {cache_bytes} bytes; decode_step at "
          f"position {s} against the prefill of {s + 1} tokens: max rel "
          f"err {err:.3e} (<= {LM_TOL['default']}); the two prefills' K/V "
          f"caches at their {s} shared positions: max rel err {shared:.3e}")
    assert err <= LM_TOL["default"], err
    gen_ids, last, finite, caches = _greedy(
        lm, params, caches, dec.argmax(-1)[:, None], s + 1, 1)  # warm-up
    (gen_ids, last, finite, caches), dec_ms = _event_ms(
        lambda: _greedy(lm, params, caches, gen_ids[:, -1:], s + 2,
                        LM_DECODE))
    assert finite and gen_ids.shape == (b, LM_DECODE)
    assert int(gen_ids.max()) < lm.vpad
    step_ms = dec_ms / LM_DECODE
    bound_ms = 1e3 * (pbytes + cache_bytes) / HBM_BYTES_PER_S
    wall, dev, launches, _ = _profile_device(
        lambda: _greedy(lm, params, caches, gen_ids[:, -1:],
                        s + 2 + LM_DECODE, 4))
    busy = ("device time not recorded by the profiler" if dev is None else
            f"device time {dev / 4:.2f} ms and {launches / 4:.0f} launches "
            f"per step, busy share {dev / wall:.3f}")
    print(f"phase 9a greedy decode of {LM_DECODE} tokens x {b} sequences "
          f"(first step, after the check, {first_ms:.1f} ms): "
          f"{step_ms:.2f} ms/step, {b / step_ms * 1e3:.0f} tokens/s; bytes "
          f"bound of a step (parameters + caches once over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) {bound_ms:.3f} ms; profiler "
          f"over 4 more steps: wall {wall / 4:.2f} ms/step, {busy}")

    # chunked attention at this width, then a prompt long enough to take it
    q, k, v = (torch.randn((1, 4096, cfg.n_heads, cfg.dh), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    chunked = attention(q, k, v, causal=True, kv_chunk=1024)
    plain = attention(q, k, v, causal=True, kv_chunk=0)
    cerr = _rel_err(plain, chunked)
    assert cerr <= LM_TOL["default"], cerr
    del q, k, v, chunked, plain, caches
    long = torch.randint(0, cfg.vocab, (1, 4096), generator=gen,
                         device="cuda")
    assert 4096 > 2 * cfg.attn_chunk and 4096 % cfg.attn_chunk == 0
    (llog, _), long_ms = _event_ms(lambda: lm.prefill(params, long, 4096))
    assert bool(torch.isfinite(llog).all())
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 9a attention (1, 4096, {cfg.n_heads}, {cfg.dh}) bf16, "
          f"kv_chunk 1024 against unchunked: max rel err {cerr:.3e}; "
          f"prefill 1x4096 through the chunked path ({4096 // cfg.attn_chunk}"
          f" KV chunks per layer): {long_ms:.1f} ms, logits finite; peak "
          f"memory allocated in 9a {peak} bytes")


def _decode_vs_prefill(lm, params, toks, max_seq: int) -> tuple:
    """Prefill toks[:, :-1] (timed, after a warm-up that prefills all of
    toks) and decode the last token from its caches; returns (prefill ms,
    the decode step's logits, the caches, max rel err of those logits
    against the prefill of all of toks)."""
    import torch
    s = toks.shape[1] - 1
    (full, _), _ = _event_ms(lambda: lm.prefill(params, toks, max_seq))
    (logits, caches), pre_ms = _event_ms(
        lambda: lm.prefill(params, toks[:, :s], max_seq))
    assert bool(torch.isfinite(logits).all())
    dec, caches = lm.decode_step(params, caches, toks[:, s:], s)
    return pre_ms, dec, caches, _rel_err(full, dec)


def _lm_published_widths() -> None:
    """Phase 9b: the other families at their published widths, depth cut.
    For the MoE arch the decode check runs twice: at the published capacity
    factor, where the prefill of s+1 tokens can drop the last token's
    expert assignments while a one-token decode step never does (printed),
    and with a capacity no expert can exceed (held to the tolerance)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import moe_capacity
    from repro_torch.models.lm import LM
    b, s = LM_CUT_BATCH, LM_CUT_PROMPT
    max_seq = s + LM_CUT_DECODE
    for name, prof in LM_CUT:
        cfg = get_config(name)
        torch.cuda.reset_peak_memory_stats()
        lm = LM(cfg, depth_profile=prof)
        gen = torch.Generator(device="cuda").manual_seed(1)
        params = lm.init_params(gen)
        depth = {seg.name: seg.count for seg in lm.segments}
        toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                             device="cuda")
        pre_ms, dec, caches, err = _decode_vs_prefill(lm, params, toks,
                                                      max_seq)
        check = f"max rel err {err:.3e} (<= {_lm_tol(cfg)})"
        if cfg.moe is not None:
            roomy = LM(dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts))),
                depth_profile=prof)
            roomy.load_params(params)
            err_roomy = _decode_vs_prefill(roomy, params, toks, max_seq)[3]
            check = (f"max rel err {err:.3e} at capacity factor "
                     f"{cfg.moe.capacity_factor} (capacity "
                     f"{moe_capacity(cfg, s + 1)} slots for {s + 1} tokens x "
                     f"top-{cfg.moe.top_k} over {cfg.moe.num_experts} "
                     f"experts: the prefill may drop the last token's "
                     f"assignments, the decode step drops none), "
                     f"{err_roomy:.3e} with no drop possible "
                     f"(<= {_lm_tol(cfg)})")
            err = err_roomy
            del roomy
        assert err <= _lm_tol(cfg), (name, check)
        (ids, last, finite, _), dec_ms = _event_ms(
            lambda: _greedy(lm, params, caches, dec.argmax(-1)[:, None],
                            s + 1, LM_CUT_DECODE - 1))
        assert finite and bool(torch.isfinite(dec).all())
        step_ms = dec_ms / (LM_CUT_DECODE - 1)
        print(f"phase 9b {name} ({cfg.family}, d {cfg.d_model}, depth "
              f"{depth}, {_nbytes(params)} bytes of parameters): prefill "
              f"{b}x{s} {pre_ms:.1f} ms ({b * s / pre_ms * 1e3:.0f} "
              f"tokens/s); decode against the prefill of {s + 1}: {check}; "
              f"{LM_CUT_DECODE} decode steps, finite, the last "
              f"{LM_CUT_DECODE - 1} at {step_ms:.2f} ms/step "
              f"({b / step_ms * 1e3:.0f} tokens/s); peak memory "
              f"{torch.cuda.max_memory_allocated()} bytes")
        del lm, params, caches, dec
        torch.cuda.empty_cache()


def _lm_reduced_on_card() -> None:
    """Phase 9c: the ten reduced configs on the card against the port on
    the CPU, with the same parameters; then the serving CLI."""
    import torch
    from repro_torch.configs import ARCH_NAMES, reduced_config
    from repro_torch.models.lm import LM
    from repro_torch.models.spec import tree_map
    b, s, max_seq = 2, 32, 64
    for name in ARCH_NAMES:
        cfg = reduced_config(name)
        cpu = LM(cfg, device="cpu")
        pc = cpu.init_params(torch.Generator().manual_seed(0))
        card = LM(cfg)
        pg = card.load_params(tree_map(lambda t: t.detach().to("cuda"), pc))
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=g)
        mem = None
        if cfg.family in ("vlm", "encdec"):
            mem = (torch.randn((b, cfg.frontend_tokens or 16, cfg.d_model),
                               generator=g) * 0.05).to(torch.bfloat16)
        gmem = None if mem is None else mem.cuda()
        batch = {"tokens": toks[:, :s], "loss_mask": torch.ones(b, s),
                 "memory": mem}
        with torch.no_grad():
            lc = cpu.train_loss(pc, batch)
            lg = card.train_loss(pg, {k: None if v is None else v.cuda()
                                      for k, v in batch.items()})
        cl, cc = cpu.prefill(pc, toks[:, :s], max_seq, mem)
        gl, gc = card.prefill(pg, toks[:, :s].cuda(), max_seq, gmem)
        errs = {"loss": abs(float(lc) - float(lg)) / abs(float(lc)),
                "prefill": _rel_err(cl, gl), "caches": _tree_rel_err(cc, gc)}
        cd, cc = cpu.decode_step(pc, cc, toks[:, s:], s, mem)
        gd, gc = card.decode_step(pg, gc, toks[:, s:].cuda(), s, gmem)
        errs.update(decode=_rel_err(cd, gd), decode_caches=_tree_rel_err(cc, gc))
        tol = _lm_tol(cfg)
        assert all(v <= tol for v in errs.values()), (name, errs)
        print(f"phase 9c {name} ({cfg.family}) card vs CPU, max rel err "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (<= {tol})")
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, str(root / "examples" / "serve_decode_torch.py"),
         "--arch", LM_FULL], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("prefill 4x32:"), lines
    assert lines[1].startswith("decoded 16 tokens/seq in"), lines
    print(f"phase 9c serve_decode_torch.py --arch {LM_FULL} (a process, "
          f"{time.time() - t0:.1f} s): {lines[0]}; {lines[1]}")


def _phase_lm() -> None:
    """Phase 9: the LM zoo's serving path (no kernel of ours runs here)."""
    t0 = time.time()
    _lm_full_width()
    _lm_published_widths()
    _lm_reduced_on_card()
    print(f"phase 9 time: {time.time() - t0:.1f} s")


BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 dense, tensor cores
LM10A: dict = {}   # 10a's first loss and grad norm, step ms, peak (phase 11)
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 2, 4096, 10
LM_TRAIN_CUT_BATCH, LM_TRAIN_CUT_SEQ, LM_TRAIN_CUT_STEPS = 4, 512, 3


def _lm_batch(stream, device) -> dict:
    import torch
    return {k: torch.from_numpy(v).to(device) for k, v in next(stream).items()}


def _lm_flops(cfg, n_params: int, b: int, s: int) -> float:
    """Model FLOPs of one training step: 6·N·tokens for the parameters'
    products (the tied embedding counted once, as the head), plus the
    attention's two products forward and twice that backward over the
    whole S×S square the port computes (masked, not skipped); remat's
    recomputation is not model work and is not counted."""
    attn = 12 * cfg.n_layers * b * s * s * cfg.n_heads * cfg.dh
    return 6.0 * n_params * b * s + attn


def _lm_train_full_width() -> None:
    """Phase 10a: llama3.2-1b trained at its published widths."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models.lm import LM
    from repro_torch.models.spec import tree_leaves
    from repro_torch.optim import make_optimizer, tree_map
    cfg = get_config(LM_FULL)
    b, s = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    assert (cfg.optimizer, cfg.remat, cfg.microbatches) == ("adamw", "full", 1)
    assert s == SHAPES["train_4k"].seq_len and s > 2 * cfg.attn_chunk
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg)
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    opt = make_optimizer(cfg.optimizer, lr=3e-3)
    state = opt.init(params)
    step = make_lm_train_step(lm, opt)
    stream = TokenStream(cfg.vocab, b, s, seed=0)
    losses, gnorms, step_ms = [], [], []
    for _ in range(LM_TRAIN_STEPS):
        batch = _lm_batch(stream, "cuda")
        (params, state, m), ms = _event_ms(lambda: step(params, state, batch))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_ms.append(ms)
    assert all(math.isfinite(x) for x in losses + gnorms), (losses, gnorms)
    assert losses[-1] < losses[0], losses
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms[1:])
    flops = _lm_flops(cfg, n_params, b, s)
    LM10A.update(loss0=losses[0], gnorm0=gnorms[0], step_ms=med, peak=peak,
                 n_params=n_params, flops=flops)
    print(f"phase 10a {LM_FULL} training at published widths ({n_params} "
          f"parameters, remat {cfg.remat}, AdamW lr 3e-3, TokenStream seed "
          f"0), {b}x{s} tokens per step, {cfg.n_layers} layers x "
          f"{s // cfg.attn_chunk} KV chunks of {cfg.attn_chunk}: losses "
          + " ".join(f"{x:.4f}" for x in losses) + "; grad norms "
          + " ".join(f"{x:.3f}" for x in gnorms))
    print(f"phase 10a step ms (synchronised; the first, with the allocator's "
          f"warm-up, {step_ms[0]:.1f}): median of steps 2-{LM_TRAIN_STEPS} "
          f"{med:.1f} (min {min(step_ms[1:]):.1f}, max {max(step_ms[1:]):.1f}"
          f"), {b * s / med * 1e3:.0f} tokens/s; model FLOPs per step "
          f"{flops:.4e} (6·N·tokens + attention), {flops / (med / 1e3):.4e} "
          f"FLOP/s, {flops / (med / 1e3) / BF16_FLOPS_PER_S:.4f} of the "
          f"bf16 dense peak ({BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s); peak "
          f"memory allocated {peak} bytes")

    # the optimizer's update alone, on gradients of the parameters' shapes
    grads = tree_map(lambda p: torch.full_like(p, 1e-3), params)
    upd_ms = _event_ms(lambda: opt.update(grads, state, params, opt.lr))[1]
    upd2_ms = _event_ms(lambda: opt.update(grads, state, params, opt.lr))[1]
    del grads
    batch = _lm_batch(stream, "cuda")
    out = []
    wall, dev, launches, events = _profile_device(
        lambda: out.append(step(params, state, batch)))
    busy = ("device time not recorded by the profiler" if dev is None else
            f"device {dev:.1f} ms in {launches} launches, busy share "
            f"{dev / wall:.3f}; by kind (ms) " + ", ".join(
                f"{k} {v:.1f}" for k, v in sorted(
                    _kernel_kinds(events).items(), key=lambda kv: -kv[1]))
            + "; top kernels " + "; ".join(
                f"{k[:80]} {ms:.1f} ms x{n}" for k, (ms, n) in sorted(
                    events.items(), key=lambda kv: -kv[1][0])[:4]))
    print(f"phase 10a AdamW update alone (1 step over {n_params} parameters,"
          f" synchronised): {upd_ms:.1f} ms, again {upd2_ms:.1f} ms; "
          f"profiler, one more train step: wall {wall:.1f} ms, {busy}")
    assert bool(torch.isfinite(out[0][2]["loss"]))


def _lm_train_published_widths() -> None:
    """Phase 10b: the other families trained at published widths, depth
    cut; the MoE block's backward twice, bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models import blocks as TB
    from repro_torch.models.lm import LM
    from repro_torch.optim import make_optimizer
    b, s = LM_TRAIN_CUT_BATCH, LM_TRAIN_CUT_SEQ
    cuts = (("deepseek-v2-lite-16b", {"dense_blocks": 1, "moe_blocks": 2}, 1),
            ("zamba2-1.2b", {}, 4), ("rwkv6-7b", {"blocks": 2}, 4))
    for name, prof, n_mb in cuts:
        cfg = get_config(name)
        assert cfg.microbatches == n_mb, (name, cfg.microbatches)
        torch.cuda.reset_peak_memory_stats()
        lm = LM(cfg, depth_profile=prof)
        params = lm.init_params(torch.Generator(device="cuda").manual_seed(1))
        opt = make_optimizer(cfg.optimizer, lr=3e-3)
        state = opt.init(params)
        step = make_lm_train_step(lm, opt)
        stream = TokenStream(cfg.vocab, b, s, seed=0)
        losses, ms = [], []
        for _ in range(LM_TRAIN_CUT_STEPS):
            batch = _lm_batch(stream, "cuda")
            (params, state, m), t = _event_ms(
                lambda: step(params, state, batch))
            losses.append(float(m["loss"]))
            ms.append(t)
            assert bool(torch.isfinite(m["loss"])) and \
                bool(torch.isfinite(m["grad_norm"])), (name, m)
        depth = {seg.name: seg.count for seg in lm.segments}
        extra = ""
        if cfg.moe is not None:
            # the full-width MoE block's backward, twice: gathers only
            lp = {k: v[0].detach().requires_grad_(True)
                  for k, v in params["moe_blocks"]["moe"].items()}
            g = torch.Generator(device="cuda").manual_seed(2)
            h = torch.randn((b, s, cfg.d_model), generator=g,
                            device="cuda").to(torch.bfloat16)
            ct = torch.randn(h.shape, generator=g,
                             device="cuda").to(torch.bfloat16)
            runs = []
            for _ in range(2):
                x = h.detach().requires_grad_(True)
                out = TB.moe_apply(lp, x, cfg)
                runs.append(torch.autograd.grad(out, [x, *lp.values()], ct))
            assert all(torch.equal(u, v) for u, v in zip(*runs))
            extra = (f"; the MoE block's backward ({b}x{s} tokens, "
                     f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}) "
                     f"twice: {len(runs[0])} gradients equal bit for bit")
        print(f"phase 10b {name} ({cfg.family}, d {cfg.d_model}, depth "
              f"{depth}, {cfg.optimizer}, {n_mb} microbatch(es), remat "
              f"{cfg.remat}, {_nbytes(params)} bytes of parameters): "
              f"{LM_TRAIN_CUT_STEPS} steps of {b}x{s} tokens, losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; step ms " + " ".join(f"{x:.1f}" for x in ms)
              + f"; peak memory {torch.cuda.max_memory_allocated()} bytes"
              + extra)
        del lm, params, state, step
        torch.cuda.empty_cache()


def _lm_train_reduced_on_card() -> None:
    """Phase 10c: one train step of each of the ten reduced configs on the
    card against the port on the CPU, with the same parameters (constant
    leaves moved off their constants) and batch; then AdamW-8bit once;
    then the training CLI (10d)."""
    import torch
    from repro_torch.configs import ARCH_NAMES, reduced_config
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models.lm import LM
    from repro_torch.models.spec import tree_leaves
    from repro_torch.optim import make_optimizer, tree_map

    def moved(spec, t, gen):
        # a leaf initialized to a constant (biases, gates, decays, norm
        # scales) moved off it, as tests/_torch_lm.py does: else a first
        # update, about lr·sign(g) per entry, is the whole of its value
        if spec.init == "zeros":
            return 0.5 * torch.randn(t.shape, generator=gen)
        if spec.init == "ones":
            return 1 + 0.1 * torch.randn(t.shape, generator=gen)
        return t.detach().float()

    def one_step(name, dtype, opt_name=None):
        cfg = reduced_config(name)
        cpu, card = LM(cfg, device="cpu"), LM(cfg)
        gen = torch.Generator().manual_seed(0)
        pc = cpu.init_params(gen)
        pc = tree_map(lambda sp, t: moved(sp, t, gen).to(dtype),
                      cpu.params_spec(), pc)
        pg = tree_map(lambda t: t.to("cuda"), pc)
        b = max(2, cfg.microbatches)
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (b, 64), generator=g),
                 "loss_mask": torch.ones(b, 64)}
        if cfg.family in ("vlm", "encdec"):
            batch["memory"] = (torch.randn(
                (b, cfg.frontend_tokens or 16, cfg.d_model), generator=g)
                * 0.05).to(dtype)
        outs = []
        for lm, params in ((cpu, pc), (card, pg)):
            opt = make_optimizer(opt_name or cfg.optimizer)
            outs.append(make_lm_train_step(lm, opt)(params, opt.init(params),
                                                    batch))
        (p_c, _, m_c), (p_g, _, m_g) = outs
        errs = {k: abs(float(m_c[k]) - float(m_g[k])) / abs(float(m_c[k]))
                for k in ("loss", "grad_norm")}
        finite = all(bool(torch.isfinite(t).all())
                     for _, t in tree_leaves(p_g))
        if dtype == torch.float32:
            a, c = dict(tree_leaves(p_c)), dict(tree_leaves(p_g))
            errs["params"] = max(_norm_rel(c[k].cpu(), a[k]) for k in a)
        return cfg, errs, finite

    for name in ARCH_NAMES:
        cfg, e32, fin32 = one_step(name, torch.float32)
        _, e16, fin16 = one_step(name, torch.bfloat16)
        tol = _lm_tol(cfg)
        assert fin32 and fin16 and all(v <= tol for v in e32.values()) and \
            all(v <= tol for v in e16.values()), (name, e32, e16)
        print(f"phase 10c {name} ({cfg.family}, {cfg.optimizer}, "
              f"{cfg.microbatches} microbatch(es)) card vs CPU, one step: "
              f"f32 loss {e32['loss']:.2e}, grad norm {e32['grad_norm']:.2e},"
              f" new parameters per leaf in norm <= {e32['params']:.2e}; "
              f"bf16 loss {e16['loss']:.2e}, grad norm {e16['grad_norm']:.2e}"
              f" (<= {tol})")
    cfg, e8, fin8 = one_step(LM_FULL, torch.float32, "adamw8bit")
    assert fin8 and all(v <= _lm_tol(cfg) for v in e8.values()), e8
    print(f"phase 10c {LM_FULL} with adamw8bit card vs CPU, one step: f32 "
          + ", ".join(f"{k} {v:.2e}" for k, v in e8.items()))

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, str(root / "examples" / "train_lm_torch.py"),
         "--arch", LM_FULL, "--steps", "20"], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert lines[0].startswith(f"{LM_FULL} (reduced):"), lines
    assert len(steps) == 3 and steps[-1].startswith("step   19"), lines
    first, last = (float(ln.split()[3]) for ln in (steps[0], steps[-1]))
    assert last < first, lines
    print(f"phase 10d train_lm_torch.py --arch {LM_FULL} --steps 20 (a "
          f"process, {time.time() - t0:.1f} s): {lines[0]}; "
          + "; ".join(steps))


def _phase_lm_train() -> None:
    """Phase 10: the LM zoo's training path (no kernel of ours runs here:
    the launch counts stay 0)."""
    import torch
    t0 = time.time()
    _zero_counts()
    for part in (_lm_train_full_width, _lm_train_published_widths,
                 _lm_train_reduced_on_card):
        torch.cuda.empty_cache()    # each part starts from a clean cache
        part()
    counts = _read_counts()
    assert not any(counts.values()), counts
    print(f"phase 10 time: {time.time() - t0:.1f} s; launches of the four "
          f"kernels in phase 10: {counts}")


LM_SHARDED_STEPS = 3


def _lm_train_one_rank_mesh() -> None:
    """Phase 11a: 10a's configuration through ``build_cell`` on an NCCL
    mesh of one rank: parameters, optimizer state and batch are DTensors,
    the activation constraints registered."""
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenStream
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.dist.sharding import distribute
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import spec
    from repro_torch.optim import make_optimizer
    cfg = get_config(LM_FULL)
    b, s = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'init'}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        opt = make_optimizer(cfg.optimizer, lr=3e-3)
        lm, step, _, (p_sh, s_sh, b_sh) = build_cell(
            cfg, ShapeConfig("train_4k", "train", s, b), mesh, opt=opt)
        torch.cuda.reset_peak_memory_stats()
        # 10a's parameters (the same generator and seed), then placed
        params = spec.materialize(
            lm.params_spec(), torch.Generator(device="cuda").manual_seed(0),
            "cuda", p_sh, mesh)
        state = spec.materialize(opt.state_spec(lm.params_spec()),
                                 torch.Generator(device="cuda"), "cuda", s_sh,
                                 mesh)
        stream = TokenStream(cfg.vocab, b, s, seed=0)
        losses, gnorms, step_ms = [], [], []
        for _ in range(LM_SHARDED_STEPS):
            batch = distribute(_lm_batch(stream, "cuda"), b_sh, mesh)
            (params, state, m), ms = _event_ms(
                lambda: step(params, state, batch))
            losses.append(float(m["loss"].full_tensor()))
            gnorms.append(float(m["grad_norm"].full_tensor()))
            step_ms.append(ms)
        assert all(isinstance(t, DTensor) for _, t in
                   spec.tree_leaves(params)), "parameters left the mesh"
        peak = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
    assert all(math.isfinite(x) for x in losses + gnorms), (losses, gnorms)
    loss_rel = abs(losses[0] - LM10A["loss0"]) / abs(LM10A["loss0"])
    gn_rel = abs(gnorms[0] - LM10A["gnorm0"]) / abs(LM10A["gnorm0"])
    med = statistics.median(step_ms[1:])
    LM10A["mesh_peak"] = peak
    print(f"phase 11a {LM_FULL} train step through build_cell on an NCCL "
          f"mesh (1, 1) over (data, model), parameters/state/batch DTensors,"
          f" {b}x{s} tokens, {LM_SHARDED_STEPS} steps: losses "
          + " ".join(f"{x:.6f}" for x in losses) + "; grad norms "
          + " ".join(f"{x:.6f}" for x in gnorms)
          + f"; first loss {losses[0]!r} vs 10a {LM10A['loss0']!r} (rel "
          f"{loss_rel:.3g}, bit-equal {losses[0] == LM10A['loss0']}; rtol "
          f"1e-4), first grad norm {gnorms[0]!r} vs 10a "
          f"{LM10A['gnorm0']!r} (rel {gn_rel:.3g}; <= 1e-3)")
    print(f"phase 11a step ms (synchronised; the first {step_ms[0]:.1f}): "
          f"median of steps 2-{LM_SHARDED_STEPS} {med:.1f} vs 10a "
          f"{LM10A['step_ms']:.1f}; peak memory allocated {peak} bytes vs "
          f"10a {LM10A['peak']}")
    assert loss_rel <= 1e-4, (losses[0], LM10A["loss0"])
    assert gn_rel <= 1e-3, (gnorms[0], LM10A["gnorm0"])


# argument bytes a device of the GNN-LMC dry-run cell: the reference's
# record experiments/dryrun/gnn_lmc_16x16.json, and the same count by hand
# on 2x16x16 (tests/test_torch_dryrun_gnn.py)
GNN_ARG_BYTES = {"16x16": 3_099_953_416, "2x16x16": 1_554_352_392}


def _dryrun_cell(*flags: str) -> dict:
    """examples/multipod_dryrun_torch.py as a process; its JSON result."""
    env = {**os.environ,
           "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    res = subprocess.run(
        [sys.executable, str(Path(__file__).resolve().parent / "examples"
                             / "multipod_dryrun_torch.py"), "--json", *flags],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


# the LM train_4k cells' peak bytes a device: the reference's plan
# (repro.launch.dryrun.run_cell, jax 0.9.0, 512 XLA host devices: argument
# + output + temp - alias of memory_analysis()), and the port's bar: 60% of
# an 80 GB card for qwen2.5-32b, no higher than before the per-layer
# activations were freed for llama3.2-1b (PERF.md section 5)
LM_TRAIN_PEAKS = {   # tag -> (arch, the reference's peak, the port's bar)
    "16x16": (LM_FULL, 7_762_768_532, 9_484_912_772),
    "2x16x16": (LM_FULL, 3_947_581_508, 4_759_287_812),
    "qwen 16x16": ("qwen2.5-32b", 19_136_018_492, 48_000_000_000)}


def _lm_dryrun() -> None:
    """Phase 11b: the dry run of llama3.2-1b's train_4k on both production
    meshes, of qwen2.5-32b's on 16x16 and of 10a's configuration on a mesh
    of one, with the GNN cell on both meshes, six processes at once; each
    LM train cell's peak beside the reference's and held to its bar, the
    predicted peak and FLOPs beside 11a's and 10a's."""
    import concurrent.futures as cf
    base = ("--arch", LM_FULL, "--shape", "train_4k")
    cells = {"16x16": base + ("--single-pod",), "2x16x16": base,
             "qwen 16x16": ("--arch", "qwen2.5-32b", "--shape", "train_4k",
                            "--single-pod"),
             "1x1 (10a)": base + ("--mesh", "1x1", "--batch",
                                  str(LM_TRAIN_BATCH)),
             "gnn 16x16": ("--gnn", "--single-pod"), "gnn 2x16x16": ("--gnn",)}
    with cf.ThreadPoolExecutor(len(cells)) as ex:
        futs = {tag: ex.submit(_dryrun_cell, *flags)
                for tag, flags in cells.items()}
        out = {tag: f.result() for tag, f in futs.items()}
    for mesh, want in GNN_ARG_BYTES.items():
        r = out.pop(f"gnn {mesh}")
        assert r["status"] == "ok" and r["mesh"] == mesh, r
        mem, coll = r["memory"], r["collectives"]
        print(f"phase 11b dry run of the GNN-LMC cell ({r['shape']}, GCNII) "
              f"on {mesh}: argument {mem['argument_bytes']} B a device "
              f"(the reference's {want}), output {mem['output_bytes']} B, "
              f"peak {mem['peak_bytes']} B; flops {r['flops']:.4e}; "
              f"collectives " + ", ".join(f"{k} {v}" for k, v in
                                          sorted(coll.items()))
              + f"; traced in {r['step_s']:.1f} s")
        assert mem["argument_bytes"] == want, (mesh, mem)
        assert all(coll.get(k, 0) > 0 for k in
                   ("all-to-all", "all-gather", "all-reduce")), coll
    for tag, r in out.items():
        assert r["status"] == "ok", r
        mem, coll = r["memory"], r["collectives"]
        print(f"phase 11b dry run {r['arch']} train_4k on {tag} (batch "
              f"{r['global_batch']}): argument {mem['argument_bytes']} B, "
              f"output {mem['output_bytes']} B, peak {mem['peak_bytes']} B "
              f"a device; flops {r['flops']:.4e} a device; collectives "
              + ", ".join(f"{k} {v}" for k, v in sorted(coll.items()))
              + f"; traced in {r['step_s']:.1f} s (built {r['build_s']:.1f})")
    for tag, (arch, ref, bar) in LM_TRAIN_PEAKS.items():
        peak = out[tag]["memory"]["peak_bytes"]
        assert out[tag]["arch"] == arch, out[tag]
        print(f"phase 11b {arch} train_4k on {tag.split()[-1]}: peak {peak} "
              f"B a device, the reference's plan {ref} B (ratio "
              f"{peak / ref:.3f}), bar {bar} B")
        assert peak <= bar, (tag, peak, bar)
    one = out["1x1 (10a)"]
    print(f"phase 11b 10a's configuration: dry-run peak "
          f"{one['memory']['peak_bytes']} B vs 11a's measured "
          f"{LM10A['mesh_peak']} B (10a's plain step {LM10A['peak']} B), "
          f"ratio {one['memory']['peak_bytes'] / LM10A['mesh_peak']:.3f}; "
          f"dry-run FLOPs {one['flops']:.4e} vs _lm_flops "
          f"{LM10A['flops']:.4e} (6·N·tokens + attention, no remat), ratio "
          f"{one['flops'] / LM10A['flops']:.3f}")


class StackProbe:
    """While active, records every ``torch.stack`` of DTensors: per call
    site (``file:line``), the set of (distinct operand placements, the
    collectives the stack ran) seen there. (A copy of
    ``tests/_torch_lm_dist.py``'s, kept here so this script needs nothing
    of the tests.)"""

    def __init__(self):
        self.seen: dict = {}

    def __enter__(self):
        import torch
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.debug import CommDebugMode
        self._orig = orig = torch.stack

        def stack(tensors, *args, **kw):
            tensors = list(tensors)
            if not (tensors and isinstance(tensors[0], DTensor)):
                return orig(tensors, *args, **kw)
            frame = sys._getframe(1)
            where = (f"{os.path.basename(frame.f_code.co_filename)}:"
                     f"{frame.f_lineno}")
            with CommDebugMode() as comm:
                out = orig(tensors, *args, **kw)
            self.seen.setdefault(where, set()).add(
                (len({t.placements for t in tensors}),
                 comm.get_total_counts()))
            return out
        torch.stack = stack
        return self

    def __exit__(self, *exc):
        import torch
        torch.stack = self._orig


def _kept_stack_sites() -> set:
    """``file:line`` of every raw ``torch.stack`` kept under an R001 pragma
    in the LM's model code (models/lm.py, models/ssm.py)."""
    root = Path(__file__).resolve().parent / "src" / "repro_torch" / "models"
    sites = set()
    for name in ("lm.py", "ssm.py"):
        lines = (root / name).read_text().splitlines()
        for i, line in enumerate(lines):
            if "torch.stack(" in line and "lint: ok(R001)" in lines[i - 1]:
                sites.add(f"{name}:{i + 1}")
    return sites


def _stack_probe() -> None:
    """Phase 11c: every kept raw ``torch.stack`` site on the card's torch:
    the ten reduced archs' prefill and decode dry-run cells on a fake
    (2, 2, 2) CUDA mesh, each stack of DTensors recorded; each kept site
    must be reached, meet one placement and run no collective."""
    import logging
    import torch
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.launch.dryrun import run_cell
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    t0 = time.time()
    with StackProbe() as probe:
        for shape in ("prefill_32k", "decode_32k"):
            for arch in ARCH_NAMES:
                r = run_cell(arch, shape, multi_pod=True, device="cuda",
                             mesh_shape=(2, 2, 2), global_batch=8,
                             seq_len=64, reduced=True, verbose=False)
                assert r["status"] == "ok", r
    sites = _kept_stack_sites()
    for where in sorted(probe.seen):
        print(f"phase 11c torch {torch.__version__}: torch.stack at {where}: "
              f"(placements, collectives) seen {sorted(probe.seen[where])}")
    assert set(probe.seen) == sites, (sorted(probe.seen), sorted(sites))
    assert all(v == {(1, 0)} for v in probe.seen.values()), probe.seen
    print(f"phase 11c every kept stack site ({', '.join(sorted(sites))}) "
          f"meets one placement and runs no collective on torch "
          f"{torch.__version__} (20 reduced cells on a fake 2x2x2 CUDA mesh, "
          f"{time.time() - t0:.1f} s)")


def _phase_lm_sharded() -> None:
    """Phase 11: the LM on a device mesh (11a), the dry run (11b) and the
    kept stack sites on the card's torch (11c); no kernel of ours runs
    here."""
    import torch
    t0 = time.time()
    _zero_counts()
    torch.cuda.empty_cache()
    _lm_train_one_rank_mesh()
    torch.cuda.empty_cache()
    _lm_dryrun()
    _stack_probe()
    counts = _read_counts()
    assert not any(counts.values()), counts
    print(f"phase 11 time: {time.time() - t0:.1f} s; launches of the four "
          f"kernels in phase 11: {counts}")


def _gat_module():
    return importlib.import_module("repro_torch.kernels.gat_attention")


def _gat_ppi():
    """The ppi-like graph (seed 0) and its sampler as the GAT-PPI cell
    takes them: 32 parts (partition seed 0), 4 clusters a batch, sampler
    seed 0."""
    from repro_torch.graph import (ClusterSampler, make_sbm_dataset,
                                   partition_graph)
    graph = make_sbm_dataset("ppi-like", seed=0)
    return graph, ClusterSampler(graph, PARTS, CLUSTERS, seed=0,
                                 parts=partition_graph(graph, PARTS, seed=0))


def _gat_kernel_bytes(rows: int, edges: int, heads: int,
                      width: int) -> dict:
    """Each attention kernel's least (bytes, flops) over ``rows`` rows and
    ``edges`` edges, self loops included: its inputs read once, its
    outputs written once, a source index per edge; the forward writes
    ``o`` (n, H, F) and ``lse``; ``dst`` reads ``z``, ``go``, ``u``, ``v``,
    ``lse`` and writes ``D`` and ``dv``; ``src`` reads ``D`` besides and
    writes ``dz`` and ``du``. Per edge and head the forward's softmax (5)
    and a multiply-add per feature; each backward pass its softmax (8) and
    two multiply-adds per feature."""
    nhf, nh = rows * heads * width, rows * heads
    fwd, bwd = edges * heads * (2.0 * width + 5), \
        edges * heads * (4.0 * width + 8)
    return {"gat_attn_fwd": (4 * (2 * nhf + 3 * nh + edges), fwd),
            "gat_attn_dst": (4 * (2 * nhf + 5 * nh + edges), bwd),
            "gat_attn_src": (4 * (3 * nhf + 5 * nh + edges), bwd)}


def _gat_kernel_case(plan, sg, heads: int, width: int, concat: bool,
                     reps: int = 10) -> dict:
    """The three attention kernels at one GAT-PPI layer's shape over the
    batch's plan: the forward and the backward against their plain twins
    on the same card inputs (the largest gap over the largest value, 1e-5;
    ``du`` and ``dv`` over their terms' scale ``|go|·|z|``, as
    tests/test_torch_gpu_gat.py holds them), twice bit for bit (no
    atomics), then each kernel timed beside its own bound, and the forward
    and the backward beside ``yardstick.attention_work`` /
    ``attention_vjp_work`` over the batch's real rows and edges."""
    import torch
    from perfbench.yardstick import (attention_vjp_work, attention_work,
                                     least_seconds)
    GAT = _gat_module()
    n = sg.n_ext
    gen = torch.Generator(device="cuda").manual_seed(heads * width)
    z = torch.randn((n, heads, width), generator=gen, device="cuda")
    u, v = (torch.randn((n, heads), generator=gen, device="cuda")
            for _ in range(2))
    go = torch.randn((n, heads, width), generator=gen, device="cuda")

    def kernels():
        o, lse = GAT.attention_forward(plan.fwd, z, u, v)
        out = (o, lse, *GAT.attention_backward(plan, z, u, v, lse, go))
        torch.cuda.synchronize()
        return out

    before = GAT.LAUNCHES
    got = kernels()
    assert GAT.LAUNCHES == before + GAT.LAUNCHES_FORWARD \
        + GAT.LAUNCHES_BACKWARD, GAT.LAUNCHES - before
    o, lse = GAT.attention_plain(plan.fwd, z, u, v)
    want = (o, lse, *GAT.attention_vjp_plain(plan, z, u, v, lse, go))
    scale = float(go.abs().max() * z.abs().max())
    gaps = {}
    for name, a, b in zip(("o", "lse", "dz", "du", "dv"), got, want,
                          strict=True):
        assert torch.isfinite(a).all(), name
        ref = scale if name in ("du", "dv") else float(b.abs().max())
        gaps[name] = float((a - b).abs().max()) / ref
        assert gaps[name] <= TOL_F32, (heads, width, name, gaps[name])
    assert all(torch.equal(a, b) for a, b in zip(got, kernels())), \
        f"{heads}x{width}: two runs of the attention kernels differ"
    del o, want
    lse, d = got[1], GAT.dst_plain(plan.fwd, z, u, v, got[1], go)[0]
    o_, lse_, d_, dv_ = (torch.empty_like(t) for t in (z, u, u, u))
    dz_, du_ = torch.empty_like(z), torch.empty_like(u)
    runs = {
        "gat_attn_fwd": (
            lambda: GAT._launch("repro_gat_attn_fwd", GAT._FWD_ARGTYPES,
                                (z, u, v, o_, lse_), plan.fwd, z),
            lambda: GAT.attention_plain(plan.fwd, z, u, v)),
        "gat_attn_dst": (
            lambda: GAT._launch("repro_gat_attn_dst", GAT._DST_ARGTYPES,
                                (z, u, v, lse, go, d_, dv_), plan.fwd, z),
            lambda: GAT.dst_plain(plan.fwd, z, u, v, lse, go)),
        "gat_attn_src": (
            lambda: GAT._launch("repro_gat_attn_src", GAT._SRC_ARGTYPES,
                                (z, u, v, lse, go, d, dz_, du_), plan.bwd,
                                z),
            lambda: GAT.src_plain(plan.bwd, z, u, v, lse, go, d))}
    rows = sg.n_batch_real + sg.n_halo_real
    edges = int(GAT._edges(plan.fwd)[0].numel())   # real + self loops
    work = _gat_kernel_bytes(n, edges, heads, width)
    label = f"{heads}x{width} {'concatenated' if concat else 'averaged'}"
    out = {}
    for name, (kernel, plain) in runs.items():
        out[name] = {"err": max(gaps.values()), "ms": _time_ms(kernel, reps),
                     "plain_ms": _time_ms(plain, 3),
                     "bound_ms": _bound_ms(*work[name]), "library_ms": None}
        print(f"phase 12 {name} {label} (n={n}, E'={edges}): ms="
              f"{out[name]['ms']:.4f} plain_ms={out[name]['plain_ms']:.4f} "
              f"(the twin on the card) bound_ms={out[name]['bound_ms']:.5f} "
              f"({work[name][0] / 1e9:.4f} GB, {work[name][1] / 1e9:.3f} "
              f"GFLOP; no library call computes it)")
    wide = heads * width if concat else width
    fwd_least = 1e3 * least_seconds(*attention_work(
        rows, sg.n_edges_real, heads, width, wide))
    bwd_least = 1e3 * least_seconds(*attention_vjp_work(
        rows, sg.n_edges_real, heads, width, wide))
    fwd_ms = out["gat_attn_fwd"]["ms"]
    bwd_ms = out["gat_attn_dst"]["ms"] + out["gat_attn_src"]["ms"]
    print(f"phase 12 attention {label}: kernels vs twins on the card, "
          f"largest gaps {gaps} (<= {TOL_F32}), bit-equal run to run; "
          f"forward {fwd_ms:.4f} ms vs attention_work's {fwd_least:.5f} ms "
          f"({100 * fwd_least / fwd_ms:.1f}% of the roofline), backward "
          f"(dst + src) {bwd_ms:.4f} ms vs "
          f"attention_vjp_work's {bwd_least:.5f} ms "
          f"({100 * bwd_least / bwd_ms:.1f}%), over {rows} real rows and "
          f"{sg.n_edges_real} real edges")
    return out


def _gat_train(graph, sampler) -> dict:
    """GAT-PPI (50 -> 4x256, 4x256, 6x121 averaged) through GNNTrainer (LMC,
    ell, sgd lr 0.2) for GAT_STEPS steps: finite losses, the step records'
    ``attn_launches`` and the counter at 15 a step (a forward a layer and
    two VJP calls a layer, each two launches), no SpMM, 5 compensation and
    4 ELL build launches a step. Returns the launches."""
    import torch
    from repro_torch.core import LMC
    from repro_torch.models import make_gnn
    from repro_torch.optim import sgd
    from repro_torch.train import GNNTrainer
    GAT = _gat_module()
    gnn = make_gnn("gat", graph.feature_dim, GAT_HIDDEN, graph.num_classes,
                   LAYERS, heads=GAT_HEADS[0], out_heads=GAT_HEADS[1],
                   generator=torch.Generator().manual_seed(0))
    assert gnn.store_widths() == (GAT_HIDDEN, GAT_HIDDEN, graph.num_classes)
    t0 = time.time()
    tr = GNNTrainer(gnn, LMC, graph, sampler, sgd(lr=0.2), backend="ell",
                    device="cuda")
    print(f"phase 12 GAT-PPI trainer start (stores {gnn.store_widths()} "
          f"wide on the card): {time.time() - t0:.1f} s")
    _zero_counts()
    GAT.LAUNCHES = 0
    tr.run(GAT_STEPS)
    for r in tr.history:
        print(f"phase 12 GAT-PPI step {r['step']}: loss={r['loss']:.6f} "
              f"attn_launches={r['attn_launches']} "
              f"host_ms={1e3 * r['host_s']:.1f} "
              f"step_ms={1e3 * (r['time_s'] - r['host_s']):.1f}")
    assert all(math.isfinite(r["loss"]) for r in tr.history), tr.history
    per_step = LAYERS * (GAT.LAUNCHES_FORWARD + 2 * GAT.LAUNCHES_BACKWARD)
    assert per_step == 15, per_step
    assert [r["attn_launches"] for r in tr.history] == \
        [per_step] * GAT_STEPS, tr.history
    assert GAT.LAUNCHES == per_step * GAT_STEPS, GAT.LAUNCHES
    counts, builds = _read_counts(), _build_launches()
    comp = _per_step_launches()[1]
    print(f"phase 12 launches over {GAT_STEPS} GAT-PPI steps: attention "
          f"{GAT.LAUNCHES} ({per_step} a step), {counts}, {builds}")
    assert counts == {"ell_spmm": 0, "ell_spmm_resident": 0,
                      "lmc_compensate": comp * GAT_STEPS,
                      "lmc_compensate_resident": 0}, counts
    assert builds == {"ell_rows": 2 * GAT_STEPS,
                      "ell_build": 2 * GAT_STEPS}, builds
    fwd = LAYERS * GAT.LAUNCHES_FORWARD * GAT_STEPS
    return {"gat_attn_fwd": fwd, "gat_attn_dst": 2 * fwd,
            "gat_attn_src": 2 * fwd, **counts, **builds}


def _phase_gat() -> tuple:
    """Phase 12: GAT-PPI's attention kernels at its two layer shapes on the
    ppi-like cells' first batch (epoch schedule, its ELL built on the
    card), then GAT-PPI training steps. Returns (the kernels' numbers,
    summed over the two shapes; the training's launches)."""
    import torch
    from repro_torch.core import host_batch
    from repro_torch.kernels import attention_plan
    t0 = time.time()
    graph, sampler = _gat_ppi()
    sg = sampler.build_batch(sampler.clusters_at(0, mode="epoch"))
    batch = host_batch(sg, backend="ell").to("cuda")
    plan = attention_plan(batch.ell)
    print(f"phase 12 ppi-like first batch: {sg.n_batch_real} batch + "
          f"{sg.n_halo_real} halo real rows of {sg.n_ext}, "
          f"{sg.n_edges_real} real edges, ELL buckets "
          f"{[tuple(i.shape) for i in batch.ell.bucket_idx]} "
          f"({time.time() - t0:.1f} s)")
    numbers: dict = {}
    for heads, width, concat in ((GAT_HEADS[0], GAT_HIDDEN // GAT_HEADS[0],
                                  True),
                                 (GAT_HEADS[1], graph.num_classes, False)):
        for name, c in _gat_kernel_case(plan, sg, heads, width,
                                        concat).items():
            acc = numbers.setdefault(name, {"err": 0.0, "ms": 0.0,
                                            "plain_ms": 0.0, "bound_ms": 0.0,
                                            "library_ms": None})
            acc["err"] = max(acc["err"], c["err"])
            for k in ("ms", "plain_ms", "bound_ms"):
                acc[k] += c[k]
        torch.cuda.empty_cache()
    del batch, plan
    launches = _gat_train(graph, sampler)
    print(f"phase 12 time: {time.time() - t0:.1f} s")
    return numbers, launches


KERNEL_FILES = {   # name -> (source, TPU kernel, wrappers, main path first)
    "ell_spmm": ("src/repro_torch/csrc/ell_spmm.cu",
                 "src/repro/kernels/ell_spmm.py:97",
                 ["ell_spmm_scatter", "ell_spmm"]),
    "ell_spmm_resident": ("src/repro_torch/csrc/ell_spmm.cu",
                          "src/repro/kernels/ell_spmm.py:71",
                          ["ell_spmm_resident_scatter", "ell_spmm_resident"]),
    "lmc_compensate": ("src/repro_torch/csrc/compensate.cu",
                       "src/repro/kernels/compensate.py:54",
                       ["lmc_compensate_kernel"]),
    "lmc_compensate_resident": ("src/repro_torch/csrc/compensate.cu",
                                "src/repro/kernels/compensate.py:40",
                                ["lmc_compensate_resident"]),
    # no TPU kernel: the reference buckets each batch on the host
    "ell_rows": ("src/repro_torch/csrc/ell_build.cu", None,
                 ["ell_rows", "ELLPlan.build"]),
    "ell_build": ("src/repro_torch/csrc/ell_build.cu", None,
                  ["ell_scatter", "ELLPlan.build"]),
    # no TPU kernel: the reference has no GAT
    "gat_attn_fwd": ("src/repro_torch/csrc/gat_attention.cu", None,
                     ["attention_forward", "gat_attention"]),
    "gat_attn_dst": ("src/repro_torch/csrc/gat_attention.cu", None,
                     ["attention_backward", "gat_attention"]),
    "gat_attn_src": ("src/repro_torch/csrc/gat_attention.cu", None,
                     ["attention_backward", "gat_attention"]),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from repro_torch.graph import (ClusterSampler, make_sbm_dataset,
                                   partition_graph)
    from repro_torch.serve import StoreGateway

    _phase_build()
    _phase_analysis()
    graph = make_sbm_dataset("arxiv-like", seed=0)
    gateway = StoreGateway(graph, agg_backend="ell")
    with _SlabSpy() as slabs:
        _phase_kernels(graph, gateway)
        t0 = time.time()
        # examples/train_gnn.py: partition seed 0, sampler seed 1
        sampler = ClusterSampler(graph, PARTS, CLUSTERS,
                                 parts=partition_graph(graph, PARTS, seed=0),
                                 seed=1)
        print(f"phase 2 arxiv-like partition into {PARTS} + pad sizes: "
              f"{time.time() - t0:.1f} s")
        small = make_sbm_dataset("arxiv-cpu", seed=0)
        small_parts = partition_graph(small, PARTS, seed=0)
        numbers = _phase_train_kernels(
            sampler, ClusterSampler(small, PARTS, CLUSTERS,
                                    parts=small_parts, seed=1))
    slabs.check()
    numbers.update(_phase_build_kernels(graph, gateway, sampler))
    launches, served = _phase_slice(graph, gateway)
    train_counts, phase4 = _phase_train(graph, sampler)
    for counts in (train_counts, _phase_resident(small, small_parts),
                   _phase_supervised(graph, sampler.parts, small,
                                     small_parts, phase4),
                   _phase_serve_faults(graph, small, served),
                   _phase_distributed(graph, sampler)):
        _add(launches, counts)
    _phase_lm()
    _phase_lm_train()
    _phase_lm_sharded()
    gat_numbers, gat_launches = _phase_gat()
    numbers.update(gat_numbers)
    _add(launches, gat_launches)
    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_FILES[name][0],
         "replaces": KERNEL_FILES[name][1], "launches": launches[name],
         "max_abs_err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
         "bound_ms": c["bound_ms"], "bound_by": "bytes",
         "library_ms": c["library_ms"],
         "entry_points": KERNEL_FILES[name][2]}
        for name, c in numbers.items()]
    assert all(k["launches"] > 0 for k in kernels), kernels
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
