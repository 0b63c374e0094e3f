#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100 for the
recorded numbers):

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro``. Phases, each of
which raises on failure:

  1. build  — compile the CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
     sm_90a), one nvcc per source in parallel, and print the build time;
  2. kernels — each kernel against its plain PyTorch twin on the card, on the
     shapes the serving path gives it (a 100-target request on the
     arxiv-like graph: ELL buckets (3840, 8), (3840, 32), (4608, 128) over
     h (3776, 256); compensation of 3648 halo rows from a (169343, 256)
     store), with kernel / plain / library times (CUDA events, median, cold
     L2) and the least time the card could take (bytes over 3.35 TB/s);
  3. slice  — GNNServer(backend="ell") on the card with a 3-layer,
     256-wide GCN over arxiv-like: ~32 requests of 1-128 targets must all
     answer exact within 1e-4 of the full-graph forward, a forced ti batch
     must answer degraded, the launch counters must show both kernels on the
     path, and drain must be clean.

Output: the card's name and power limit first; per-phase lines; then one
JSON line of per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, if
CUDA is unavailable or any phase fails.
"""
from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
SPMM_SHAPES = ((3840, 8), (3840, 32), (4608, 128))
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


def _spmm_case(idx, w, h, rows, num_rows: int):
    """Kernel vs plain vs torch.sparse on one bucket; returns numbers.

    ``rows`` are the bucket's destination rows; those equal to ``num_rows``
    are padding, whose output ``bucketed_spmm`` drops. The bound counts what
    the real data needs: the distinct h rows of the real nonzeros, their idx
    and w, and one output row per distinct real destination row (the split
    pieces of one row sum into it)."""
    import torch
    from repro_torch.kernels.ell_spmm import ell_spmm, ell_spmm_plain
    out_k = ell_spmm(idx, w, h)
    out_p = ell_spmm_plain(idx, w, h)
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
    return {"err": err, "ms": _time_ms(lambda: ell_spmm(idx, w, h)),
            "plain_ms": _time_ms(lambda: ell_spmm_plain(idx, w, h)),
            "library_ms": _time_ms(lambda: torch.sparse.mm(csr, h)),
            "bound_ms": _bound_ms(nbytes, 2.0 * nnz * d), "nnz": nnz,
            "rows_real": int(real.sum()), "out_rows": out_rows}


def _phase_kernels(graph, gateway) -> list:
    import numpy as np
    import torch
    from repro_torch.kernels.compensate import (lmc_compensate_kernel,
                                                lmc_compensate_plain)
    rng = np.random.default_rng(0)
    targets = np.sort(rng.choice(graph.num_nodes, 100, replace=False))
    sg, hb = gateway.build(targets)
    ell = hb.ell.to("cuda")
    shapes = tuple(tuple(i.shape) for i in ell.bucket_idx)
    assert shapes == SPMM_SHAPES and sg.n_ext == 3776, (shapes, sg.n_ext)
    gen = torch.Generator(device="cuda").manual_seed(0)

    spmm = {}
    for dtype in (torch.float32, torch.bfloat16):
        h = torch.randn((sg.n_ext, 256), generator=gen,
                        device="cuda").to(dtype)
        cases = []
        for idx, w, rows in zip(ell.bucket_idx, ell.bucket_w,
                                ell.bucket_rows):
            c = _spmm_case(idx, w.to(dtype), h, rows, ell.num_rows)
            cases.append(c)
            print(f"phase 2 ell_spmm {str(dtype)[6:]} K={idx.shape[1]} "
                  f"rows={idx.shape[0]} real_rows={c['rows_real']} "
                  f"out_rows={c['out_rows']} "
                  f"nnz={c['nnz']}: err={c['err']:.3g} ms={c['ms']:.4f} "
                  f"plain_ms={c['plain_ms']:.4f} "
                  f"library_ms={c['library_ms']:.4f} "
                  f"bound_ms={c['bound_ms']:.5f}")
        spmm[dtype] = cases

    m, d, n = graph.num_nodes, 256, sg.n_halo
    store = torch.randn((m, d), generator=gen, device="cuda")
    gids = hb.halo_gids.to("cuda")
    mask = hb.halo_mask.to("cuda")
    fresh = torch.randn((n, d), generator=gen, device="cuda")
    comp_err = 0.0
    beta_rand = torch.rand(n, generator=gen, device="cuda")
    for name, beta in (("0", torch.zeros(n, device="cuda")),
                       ("random", beta_rand),
                       ("1", torch.ones(n, device="cuda"))):
        out_k = lmc_compensate_kernel(store, gids, beta, fresh, mask)
        out_p = lmc_compensate_plain(store, gids, beta, fresh, mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(out_k, out_p, rtol=TOL_F32, atol=TOL_F32)
        err = float((out_k - out_p).abs().max())
        comp_err = max(comp_err, err)
        print(f"phase 2 lmc_compensate beta={name}: err={err:.3g}")
    uniq = int(torch.unique(gids).numel())
    comp_bytes = uniq * d * 4 + n * d * 4 + n * 12 + n * d * 4
    comp = {"ms": _time_ms(lambda: lmc_compensate_kernel(
                store, gids, beta_rand, fresh, mask)),
            "plain_ms": _time_ms(lambda: lmc_compensate_plain(
                store, gids, beta_rand, fresh, mask)),
            "bound_ms": _bound_ms(comp_bytes, 5.0 * n * d)}
    print(f"phase 2 lmc_compensate N={n} store=({m}, {d}): "
          f"ms={comp['ms']:.4f} plain_ms={comp['plain_ms']:.4f} "
          f"bound_ms={comp['bound_ms']:.5f} (no library call computes it)")

    f32 = spmm[torch.float32]
    bf16 = spmm[torch.bfloat16]
    print(f"phase 2 ell_spmm bf16, one layer (3 buckets): "
          f"ms={sum(c['ms'] for c in bf16):.4f} "
          f"plain_ms={sum(c['plain_ms'] for c in bf16):.4f} "
          f"library_ms={sum(c['library_ms'] for c in bf16):.4f} "
          f"bound_ms={sum(c['bound_ms'] for c in bf16):.5f}")
    return [
        {"name": "ell_spmm", "route": "cuda",
         "source": "src/repro_torch/csrc/ell_spmm.cu",
         "replaces": "src/repro/kernels/ell_spmm.py:97",
         "max_abs_err": max(c["err"] for c in f32),
         "ms": sum(c["ms"] for c in f32),
         "plain_ms": sum(c["plain_ms"] for c in f32),
         "bound_ms": sum(c["bound_ms"] for c in f32), "bound_by": "bytes",
         "library_ms": sum(c["library_ms"] for c in f32)},
        {"name": "lmc_compensate", "route": "cuda",
         "source": "src/repro_torch/csrc/compensate.cu",
         "replaces": "src/repro/kernels/compensate.py:54",
         "max_abs_err": comp_err, "ms": comp["ms"],
         "plain_ms": comp["plain_ms"], "bound_ms": comp["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
    ]


def _phase_slice(graph, gateway) -> dict:
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
    # the modules themselves: the package re-exports a function as ell_spmm
    spmm_mod = importlib.import_module("repro_torch.kernels.ell_spmm")
    comp_mod = importlib.import_module("repro_torch.kernels.compensate")
    rng = np.random.default_rng(1)
    try:
        spmm_mod.LAUNCHES = 0
        comp_mod.LAUNCHES = 0
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
        spmm_n, comp_n = spmm_mod.LAUNCHES, comp_mod.LAUNCHES
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
    assert spmm_n >= 9 * (exact_batches + 1), spmm_n
    assert comp_n >= 3 * exact_batches, comp_n
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
    return {"ell_spmm": spmm_n, "lmc_compensate": comp_n}


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

    from repro_torch.graph import make_sbm_dataset
    from repro_torch.serve import StoreGateway

    _phase_build()
    graph = make_sbm_dataset("arxiv-like", seed=0)
    gateway = StoreGateway(graph, agg_backend="ell")
    kernels = _phase_kernels(graph, gateway)
    launches = _phase_slice(graph, gateway)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
