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
     Training shapes too: the streaming SpMM and compensation at the
     full-width training batch (32 parts, 4 clusters per batch on
     arxiv-like: buckets (191744, 8), (191744, 32), (216576, 128) over h
     (191616, 256); 169344 halo rows from the (169343, 256) store), and the
     resident-source kernels at the arxiv-cpu training batch (buckets
     (3072, 8), (3072, 32), (3328, 128) over h (2880, 256); 2304 halo rows
     from a (4096, 256) store), each also bit-equal to the streaming kernel,
     and a source past the shared-memory cap must raise;
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
     backward) per step; prints host sample+build ms and step ms per step;
  5. resident — the same trainer on arxiv-cpu with stream=False for 6 steps
     on the resident-source kernels only; its losses must equal a
     stream=True run from the same seed within 1e-6 relative.

Output: the card's name and power limit first; per-phase lines; then one
JSON line of per-kernel numbers (the streaming kernels at the training
shapes, launches summed over phases 3-5); the last line is
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
RESIDENT_SHAPES = ((3072, 8), (3072, 32), (3328, 128))   # arxiv-cpu, n_ext 2880
PARTS, CLUSTERS = 32, 4          # examples/train_gnn.py defaults
HIDDEN, LAYERS = 256, 3
N_TRAIN_STEPS = 6
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
               reps: int = 25, label: str = "") -> dict:
    """Compensation kernel vs its plain twin (bit for bit in f32) at β = 0,
    random and 1, and timings. The bound counts the distinct store rows of
    the gids, β, mask, fresh and the whole output (masked rows must still be
    written: 0·NaN stays NaN). ``resident`` times the resident-store kernel
    and also holds it bit for bit against the streaming one."""
    import torch
    from repro_torch.kernels.compensate import (lmc_compensate_kernel,
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
    c = {"err": err,
         "ms": _time_ms(lambda: kernel(store, gids, beta_rand, fresh, mask),
                        reps),
         "plain_ms": _time_ms(lambda: lmc_compensate_plain(
             store, gids, beta_rand, fresh, mask), reps),
         "bound_ms": _bound_ms(nbytes, 5.0 * n * d), "library_ms": None}
    if resident:
        c["stream_ms"] = _time_ms(lambda: lmc_compensate_kernel(
            store, gids, beta_rand, fresh, mask), reps)
    print(f"phase 2 {label} N={n} store={tuple(store.shape)}: "
          f"err={err:.3g} ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
          f"bound_ms={c['bound_ms']:.5f} (no library call computes it)"
          + (f" streaming_ms={c['stream_ms']:.4f}" if resident else ""))
    return c


def _spmm_layer(label: str, ell, h, resident: bool = False,
                reps: int = 25) -> dict:
    """One layer's buckets through ``_spmm_case``; per-bucket lines and the
    layer's sums."""
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
    return total


def _phase_kernels(graph, gateway) -> None:
    """The streaming kernels at the serving shapes (a 100-target request)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    targets = np.sort(rng.choice(graph.num_nodes, 100, replace=False))
    sg, hb = gateway.build(targets)
    ell = hb.ell.to("cuda")
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
               hb.halo_mask.to("cuda"), label="serving lmc_compensate")


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


def _counters() -> tuple:
    # the modules themselves: the package re-exports a function as ell_spmm
    return (importlib.import_module("repro_torch.kernels.ell_spmm"),
            importlib.import_module("repro_torch.kernels.compensate"))


def _zero_counts() -> None:
    for mod in _counters():
        mod.LAUNCHES = mod.LAUNCHES_RESIDENT = 0


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
        runs.append((loss, {**_named(grads, "grad"), "h rows": rows.h,
                            "v rows": rows.v}))
    (l_s, seg), (_, seg2), (l_e, ell) = runs
    torch.testing.assert_close(l_e, l_s, rtol=1e-4, atol=0)

    def outside(a, b):
        return int(((a - b).abs() > 1e-6 + 2e-4 * b.abs()).sum())

    worst = 0.0
    for name, b in seg.items():
        a = ell[name]
        rel = float(torch.linalg.vector_norm(a - b)
                    / torch.linalg.vector_norm(b).clamp_min(1e-30))
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


def _step_breakdown(tr, sampler) -> None:
    """Where a full-width step's time goes, on one more batch (slot 1 of the
    schedule, outside the counted run): the host build, the batch copy to
    the card, the train step and the optimizer, each synchronised; then one
    step under torch.profiler for the device time by kernel."""
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
          f"host build {host_ms:.1f} ms, batch copy to the card "
          f"{copy_ms:.1f} ms, train step {step_ms:.1f} ms, optimizer "
          f"{opt_ms:.1f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr._step(*args)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    for e in prof.key_averages():
        # device-side events only (kernels, copies): a CPU op's device time
        # repeats the time of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    if not by_name:
        print("phase 4 profiler: no device time recorded (device busy "
              "share not measured)")
        return
    total = sum(by_name.values())
    spmm = sum(v for k, v in by_name.items() if "ell_spmm" in k)
    comp = sum(v for k, v in by_name.items() if "compensate" in k)
    index_add = sum(v for k, v in by_name.items() if "indexFunc" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"phase 4 profiler, one train step: wall {wall_ms:.1f} ms, device "
          f"time {total:.1f} ms (busy share {total / wall_ms:.3f}); "
          f"ell_spmm kernels {spmm:.2f} ms, compensation kernels "
          f"{comp:.2f} ms, index_add_ {index_add:.2f} ms; top: "
          + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top))


def _phase_train(graph, sampler) -> dict:
    """LMC training at full width on the streaming kernels."""
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
    host = [r["host_s"] / r["time_s"] for r in tr.history[1:]]
    print(f"phase 4 host share of a step (device idle while the host samples "
          f"and builds; a ratio of timings, steps 2-{N_TRAIN_STEPS}): "
          f"{statistics.median(host):.3f}")
    _step_breakdown(tr, sampler)
    return counts


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


KERNEL_FILES = {
    "ell_spmm": ("src/repro_torch/csrc/ell_spmm.cu",
                 "src/repro/kernels/ell_spmm.py:97"),
    "ell_spmm_resident": ("src/repro_torch/csrc/ell_spmm.cu",
                          "src/repro/kernels/ell_spmm.py:71"),
    "lmc_compensate": ("src/repro_torch/csrc/compensate.cu",
                       "src/repro/kernels/compensate.py:54"),
    "lmc_compensate_resident": ("src/repro_torch/csrc/compensate.cu",
                                "src/repro/kernels/compensate.py:40"),
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
    graph = make_sbm_dataset("arxiv-like", seed=0)
    gateway = StoreGateway(graph, agg_backend="ell")
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
        sampler, ClusterSampler(small, PARTS, CLUSTERS, parts=small_parts,
                                seed=1))
    launches = _phase_slice(graph, gateway)
    for counts in (_phase_train(graph, sampler),
                   _phase_resident(small, small_parts)):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_FILES[name][0],
         "replaces": KERNEL_FILES[name][1], "launches": launches[name],
         "max_abs_err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
         "bound_ms": c["bound_ms"], "bound_by": "bytes",
         "library_ms": c["library_ms"]}
        for name, c in numbers.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
