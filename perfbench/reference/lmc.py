"""LMC training (Algorithm 1, Eqs. 8-15) in plain PyTorch, by its equations.

One :class:`RefLMC` holds the parameters, the SGD-momentum state and the
historical stores, a list a layer: H̄[l] (n, widths[l+1]) of layer l's
output and V̄[l] (n, widths[l+1]) of layer l+1's input, with ``widths``
from the architecture module. :meth:`RefLMC.step`
builds the batch's extended subgraph itself (``reference.graph``), runs the
compensated forward (Eq. 9: a halo row is (1-β)·H̄ + β·fresh), the loss
(Eq. 14, scaled by B/c over |V_L|), the backward message passing with its
two cotangents per layer ([V̄;0] for θ, [V̄;V̂] for the adjoints, V̂ by
Eq. 12), the SGD-momentum update with global-norm clipping, and commits the
batch rows of every layer's values and adjoints into the stores.

An architecture module (``arch_<arch>.py``) gets the aggregation as an
:class:`Agg`: called, ``torch.sparse.mm`` over the subgraph's CSR (A for the
forward, Aᵀ for the adjoints); its attributes carry the edges themselves,
for messages that are not a fixed weight times the source row. The head is
the module's ``head``/``head_vjp`` where it defines them, else a linear
layer. GEMMs are f32 with TF32 off unless ``tf32=True`` (the control);
``dtype=torch.float64`` runs the whole step in f64 (the CPU tests).
"""
from __future__ import annotations

import importlib
import warnings
from contextlib import contextmanager

import numpy as np
import torch

from perfbench.reference.graph import extended


@contextmanager
def matmul_precision(tf32: bool):
    """GEMMs in f32 (``tf32=False``) or TF32 for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def arch_module(arch: str):
    """``reference/arch_<arch>.py``: one architecture's plain layers."""
    return importlib.import_module(f"perfbench.reference.arch_{arch}")


def _csr(rows, cols, w, n, device):
    order = np.lexsort((cols, rows))
    rows, cols, w = rows[order], cols[order], w[order]
    crow = np.zeros(n + 1, np.int64)
    np.add.at(crow, rows + 1, 1)
    return csr_tensor(np.cumsum(crow), cols, w, n, device)


def csr_tensor(crow, cols, w, n, device) -> torch.Tensor:
    """An (n, n) sparse CSR tensor on ``device`` from numpy arrays."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta state"
        return torch.sparse_csr_tensor(
            torch.from_numpy(np.asarray(crow, np.int64)).to(device),
            torch.from_numpy(np.asarray(cols, np.int64)).to(device),
            torch.from_numpy(w).to(device), size=(n, n),
            check_invariants=False)


class Agg:
    """One direction of the extended subgraph's aggregation. ``agg(h)`` is
    ``torch.sparse.mm`` over the CSR whose rows are the destinations:
    ``(A h)_i = Σ_{j→i} w_ji h_j``. The edges, in the subgraph's order:
    ``src``, ``dst`` (local row ids, int64, on the device), ``w`` and the
    row count ``n``; the reverse direction (Aᵀ) is built with ``src`` and
    ``dst`` swapped."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                 n: int, device):
        self.A = _csr(dst, src, w, n, device)
        self.src = torch.from_numpy(src).to(device)
        self.dst = torch.from_numpy(dst).to(device)
        self.w = torch.from_numpy(w).to(device)
        self.n = n

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        return torch.sparse.mm(self.A, h)


def linear_head(p: dict, h: torch.Tensor) -> torch.Tensor:
    """The logits ``h W + b`` of an architecture without a head of its own."""
    return h @ p["head.w"] + p["head.b"]


def linear_head_vjp(p: dict, h: torch.Tensor, G: torch.Tensor) -> tuple:
    """``(grads, dh)`` of :func:`linear_head` for the logits' cotangent."""
    return {"head.w": h.T @ G, "head.b": G.sum(0)}, G @ p["head.w"].T


class RefLMC:
    """Plain LMC trainer over a graph given as arrays (``data.sbm``)."""

    def __init__(self, cfg: dict, graph: dict, params: dict, *,
                 num_parts: int, per_batch: int, lr: float,
                 momentum: float = 0.9, clip: float = 1.0, device="cuda",
                 tf32: bool = False, dtype: torch.dtype = torch.float32):
        self.cfg, self.g = cfg, graph
        self.arch = arch_module(cfg["arch"])
        self.dev = torch.device(device)
        self.tf32, self.dtype = tf32, dtype
        self.p = {k: v.detach().to(self.dev, dtype, copy=True)
                  for k, v in params.items()}
        self.mom = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.lr, self.momentum, self.clip = lr, momentum, clip
        L, widths = cfg["num_layers"], self.arch.widths(cfg)
        n = graph["indptr"].shape[0] - 1
        self.H = [torch.zeros((n, widths[l + 1]), device=self.dev, dtype=dtype)
                  for l in range(L)]
        self.V = [torch.zeros((n, widths[l + 1]), device=self.dev, dtype=dtype)
                  for l in range(max(L - 1, 1))]
        self.x = torch.from_numpy(graph["x"]).to(self.dev, dtype)
        self.y = torch.from_numpy(graph["y"].astype(np.int64)).to(self.dev)
        self.train = torch.from_numpy(
            graph["train_mask"].astype(np.float32)).to(self.dev, dtype)
        self.inv_vl = 1.0 / max(int(graph["train_mask"].sum()), 1)
        self.scale = float(num_parts) / float(per_batch)

    def step(self, batch_nodes: np.ndarray) -> dict:
        """One LMC step on the batch: the update and the store rows are
        applied in place; returns the loss and the gradient, ``raw`` and as
        the optimizer takes it (``grad``, clipped to the global norm)."""
        with matmul_precision(self.tf32):
            return self._step(batch_nodes)

    def _step(self, batch_nodes):
        cfg, arch, p, dev = self.cfg, self.arch, self.p, self.dev
        L = cfg["num_layers"]
        sub = extended(self.g["indptr"], self.g["indices"], batch_nodes)
        nb, R = sub["nb"], sub["ext"].shape[0]
        w = torch.from_numpy(sub["w"]).to(self.dtype).numpy()
        agg = Agg(sub["src"], sub["dst"], w, R, dev)
        agg_t = Agg(sub["dst"], sub["src"], w, R, dev)
        head = getattr(arch, "head", linear_head)
        head_vjp = getattr(arch, "head_vjp", linear_head_vjp)

        ext = torch.from_numpy(sub["ext"]).to(dev)
        bg, hg = ext[:nb], ext[nb:]
        s = torch.from_numpy(sub["s"]).to(dev, self.dtype)
        beta = torch.from_numpy(sub["beta"]).to(dev, self.dtype)[:, None]
        x = self.x[ext]
        h0 = arch.embed(p, x)
        h, ctxs, h_rows = h0, [], []
        for l in range(L):
            out, ctx = arch.layer(p, cfg, l, agg, s, h, h0)
            ctxs.append(ctx)
            h_rows.append(out[:nb])
            h = torch.cat([out[:nb],
                           (1 - beta) * self.H[l][hg] + beta * out[nb:]])
        logits = head(p, h)
        y = self.y[ext]
        tm = self.train[ext]
        logp = torch.log_softmax(logits, -1)
        f1 = -(logp[:nb].gather(1, y[:nb, None])[:, 0] * tm[:nb]).sum() \
            * self.inv_vl
        G = torch.softmax(logits, -1)
        G[torch.arange(R, device=dev), y] -= 1.0
        G = G * (tm * self.inv_vl)[:, None]
        Gb = torch.cat([G[:nb], torch.zeros_like(G[nb:])])
        grads, dh = head_vjp(p, h, Gb)
        v_bar = dh[:nb]
        v_hat = head_vjp(p, h[nb:], G[nb:])[1]
        v0 = torch.zeros_like(h0)
        v_rows = [None] * (L - 1)
        for l in reversed(range(L)):
            grads.update(arch.layer_vjp_params(
                p, cfg, l, ctxs[l],
                torch.cat([v_bar, torch.zeros_like(v_hat)])))
            if l == 0 and not arch.LAYER0_INPUT_IS_H0 and not arch.EMBED:
                break
            gh, gh0 = arch.layer_vjp_input(
                p, cfg, l, ctxs[l], torch.cat([v_bar, v_hat]), agg_t, s)
            if gh0 is not None:
                v0 = v0 + gh0
            if l >= 1:
                v_rows[l - 1] = gh[:nb]
                v_hat = (1 - beta) * self.V[l - 1][hg] + beta * gh[nb:]
                v_bar = gh[:nb]
            elif arch.LAYER0_INPUT_IS_H0:
                v0 = v0 + gh
        if arch.EMBED:
            v0[nb:] = 0.0
            grads.update(arch.embed_vjp(p, x, v0))
        grads = {k: self.scale * g for k, g in grads.items()}
        loss = float(f1) * self.scale

        gn = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        c = torch.clamp(self.clip / torch.clamp(gn, min=1e-9), max=1.0)
        clipped = {k: g * c for k, g in grads.items()}
        for k in p:
            self.mom[k] = self.momentum * self.mom[k] + clipped[k]
            p[k] = p[k] - self.lr * self.mom[k]
        for l in range(L):
            self.H[l][bg] = h_rows[l]
        for l in range(L - 1):
            self.V[l][bg] = v_rows[l]
        return {"loss": loss, "grad": clipped, "raw": grads}
