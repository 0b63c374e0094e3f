"""repro_torch.analysis: parity with the reference's analyzer, the
reference's fixtures in their torch form, mutations of the port's real
files, the CLI and the self-host gate.

Parity: the engine's pragma handling, the shared AST helpers and R006 (the
one rule whose semantics carry over unchanged) give the reference's
(rule, line, end_line, col, suppressed) on the same inputs, with the paths
mapped from ``repro/`` to ``repro_torch/``. R001/R004/R005 read different
libraries, so each of the reference's fixtures is rewritten in torch, line
for line, and must give the same count of findings on the same lines. Each
rule must also fire on a copy of a real file of the port with the invariant
broken, and the whole port must carry no unsuppressed finding.
"""
import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import test_analysis as REF_FIXTURES
from repro.analysis import analyze_source as ref_analyze
from repro.analysis import astutils as ref_astutils

from repro_torch.analysis import analyze_source, run_analysis, summarize
from repro_torch.analysis import astutils
from repro_torch.analysis.engine import all_rules
from repro_torch.analysis.rules_cuda import SMEM_OPTIN_BYTES

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
PORT = SRC / "repro_torch"
CHIP_SMOKE = REPO / "chip_smoke.py"


def findings(src, rule=None, path="fixture.py", analyze=analyze_source):
    fs = analyze(textwrap.dedent(src), path=path)
    return [f for f in fs if rule is None or f.rule == rule]


def live(src, rule=None, path="fixture.py"):
    return [f for f in findings(src, rule, path) if not f.suppressed]


def key(fs):
    return [(f.rule, f.line, f.end_line, f.col, f.suppressed) for f in fs]


def lines(fs):
    return [(f.line, f.suppressed) for f in fs]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *map(str, args)], capture_output=True, text=True,
                          env=_env(), timeout=120)


# ------------------------------------------------- parity: engine + R006
QUEUE_PATHS = [("src/repro/serve/fixture.py", "src/repro_torch/serve/fixture.py"),
               ("src/repro/data/fixture.py", "src/repro_torch/data/fixture.py"),
               ("src/repro/train/loop.py", "src/repro_torch/train/loop.py"),
               ("benchmarks/bench_serve.py", "benchmarks/bench_serve.py")]
QUEUE_FIXTURES = ["QUEUE_UNBOUNDED", "QUEUE_BOUNDED", "QUEUE_BLOCKING",
                  "QUEUE_NONBLOCKING", "QUEUE_PRAGMA"]

PRAGMA_SOURCES = {
    # a reasonless pragma suppresses nothing and is itself R000
    "reasonless": """
        import queue
        # lint: ok(R006)
        q = queue.Queue()
    """,
    # the pragma may sit in the contiguous comment block above
    "comment_block": """
        import queue
        # lint: ok(R006) fixture: FIFO of a test
        # (continued explanation on a second comment line)
        q = queue.Queue()
    """,
    # several rules in one pragma
    "multi_rule": """
        def f(q, t):
            # lint: ok(R001,R006) fixture: the peer never dies
            item = q.get()
            t.join()  # lint: ok(R004, R006) fixture: joined at shutdown
            return item
    """,
    # a pragma a line too far up suppresses nothing
    "detached": """
        import queue
        # lint: ok(R006) fixture: too far up

        q = queue.Queue()
    """,
    "syntax_error": "def f(:\n",
}


@pytest.mark.parametrize("name", QUEUE_FIXTURES)
@pytest.mark.parametrize("ref_path,path", QUEUE_PATHS)
def test_r006_matches_the_reference_on_its_fixtures(name, ref_path, path):
    src = getattr(REF_FIXTURES, name)
    want = findings(src, "R006", ref_path, analyze=ref_analyze)
    got = findings(src, "R006", path)
    assert key(got) == key(want)
    assert [f.reason for f in got] == [f.reason for f in want]


@pytest.mark.parametrize("name", sorted(PRAGMA_SOURCES))
def test_pragma_handling_matches_the_reference(name):
    src = PRAGMA_SOURCES[name]
    want = findings(src, analyze=ref_analyze,
                    path="src/repro/serve/fixture.py")
    got = findings(src, path="src/repro_torch/serve/fixture.py")
    assert key(got) == key(want)
    assert [(f.message, f.reason) for f in got if f.rule == "R000"] == \
        [(f.message, f.reason) for f in want if f.rule == "R000"]
    assert [f.reason for f in got] == [f.reason for f in want]


CONST_EXPRS = ["3", "-4", "2 * 128 + 1", "2 ** 10", "7 // 2", "7 % 3",
               "block * 2", "n * 4", "1 / 2", "x.shape[0]", "'s'", "8 // 0"]
DIMS_EXPRS = ["(2, block, 128)", "[n, 4]", "(m.shape[0], 8)", "7", "()"]
SIGNATURES = ["def f(a, b: int = 3, *args, c=4, d: int = 'x', **kw): pass",
              "def f(x, /, y=2, *, z=5, w=None): pass", "def f(): pass"]
MODULE_SOURCES = ["A = 3\nB = 'x'\nC, D = 1, 2\nE = F = 8\nG = -1\n",
                  "import numpy as np\nK = np.int32(4)\nL = 2 ** 3\n"]
STR_EXPRS = ["'a'", "('a', 'b')", "['a', 3]", "x", "('a', y)", "[]"]
IMPORT_SOURCES = [
    "import torch\nimport torch.nn.functional as F\n"
    "from torch.utils.checkpoint import checkpoint\n"
    "from torch.distributed.tensor import DTensor as DT, Shard\n",
    "import jax.numpy as jnp\nfrom jax import lax\nfrom . import sibling\n"
    "from .pkg import mod as m\nfrom os.path import *\nimport a.b.c\n",
]


def _expr(s):
    return ast.parse(s, mode="eval").body


@pytest.mark.parametrize("expr", CONST_EXPRS)
def test_const_eval_matches_the_reference(expr):
    env = {"block": 64, "n": 5}
    assert astutils.const_eval(_expr(expr), env) == \
        ref_astutils.const_eval(_expr(expr), env)


@pytest.mark.parametrize("expr", DIMS_EXPRS)
def test_const_eval_dims_matches_the_reference(expr):
    env = {"block": 64}
    assert astutils.const_eval_dims(_expr(expr), env) == \
        ref_astutils.const_eval_dims(_expr(expr), env)


@pytest.mark.parametrize("sig", SIGNATURES)
def test_param_default_env_matches_the_reference(sig):
    fn = ast.parse(sig).body[0]
    assert astutils.param_default_env(fn) == \
        ref_astutils.param_default_env(fn)
    assert astutils.param_names(fn) == ref_astutils.param_names(fn)


@pytest.mark.parametrize("src", MODULE_SOURCES)
def test_module_const_env_matches_the_reference(src):
    tree = ast.parse(src)
    assert astutils.module_const_env(tree) == \
        ref_astutils.module_const_env(tree)


@pytest.mark.parametrize("expr", STR_EXPRS)
def test_str_elements_matches_the_reference(expr):
    assert astutils.str_elements(_expr(expr)) == \
        ref_astutils.str_elements(_expr(expr))


@pytest.mark.parametrize("src", IMPORT_SOURCES)
def test_import_aliases_and_qualnames_match_the_reference(src):
    tree = ast.parse(src + "F.pad\ncheckpoint\nDT.from_local\njnp.stack\n"
                     "lax.rem\nm.x\nsibling.y\nSHARD\n")
    aliases = astutils.import_aliases(tree)
    assert aliases == ref_astutils.import_aliases(tree)
    exprs = [s.value for s in tree.body if isinstance(s, ast.Expr)]
    assert [astutils.qualname(e, aliases) for e in exprs] == \
        [ref_astutils.qualname(e, aliases) for e in exprs]
    assert aliases.get("F") in (None, "torch.nn.functional")
    if "F" in aliases:
        assert astutils.qualname(exprs[0], aliases) == \
            "torch.nn.functional.pad"
        assert astutils.qualname(exprs[1], aliases) == \
            "torch.utils.checkpoint.checkpoint"


# ------------------------------------- the reference's fixtures, in torch
# Each pair is (the reference's fixture in tests/test_analysis.py, its torch
# form), written so that every finding sits on the line of the reference's.
R001_PATH = "src/repro_torch/models/fixture.py"   # in R001's scope

R001_FIXTURES = {
    "CONCAT_BAD": """
        import torch
        def f(a, b):
            return torch.cat([a, b], dim=0)
    """,
    "STACK_BAD": """
        import torch
        def f(xs):
            return torch.stack(xs)
    """,
    "CONCAT_ALIASED": """
        from torch import concatenate as cat
        def f(a, b):
            return cat([a, b])
    """,
    "CONCAT_OK": """
        import numpy as np
        from repro_torch.dist.sharding import concat_rows
        def f(a, b):
            host = np.concatenate([a, b])        # host-side numpy: fine
            return concat_rows([a, b], axis=0)
    """,
    "CONCAT_PRAGMA": """
        import torch
        def f(a, b):
            # lint: ok(R001) operands are per-host python scalars, never sharded
            return torch.cat([a, b], dim=0)
    """,
}

# R004: the reference's traced scopes are jitted functions and custom-VJP
# pieces; the port's are the make_*_step closures and autograd Functions
R004_FIXTURES = {
    "JIT_BRANCH": """
        import torch
        def make_train_step(cfg):
            def step(x):
                if x > 0:
                    return x
                return -x
            return step
    """,
    "JIT_ITEM": """
        import torch
        def make_train_step(cfg):
            def step(x):
                return x.sum().item()
            return step
    """,
    "JIT_NP_ASARRAY": """
        import torch
        import numpy as np
        def make_infer_step(cfg):
            def infer(x):
                return x.numpy()
            return infer
    """,
    # the counterpart of a static argument: a value the factory closes over
    "JIT_STATIC_BRANCH": """
        import functools
        import torch
        def make_train_step(flag):
            def step(x):
                if flag:
                    return x
                return -x
            return step
    """,
    "JIT_SAFE_TESTS": """
        import torch
        def make_train_step(cfg):
            def step(x, y):
                if y is None:
                    return x
                if x.shape[0] > 2:
                    return x + y
                return x - y
            return step
    """,
    "VJP_BRANCH": """
        import torch
        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x
            @staticmethod
            def backward(ctx, ct):
                if ct > 0:
                    return (ct,)
                return (-ct,)
    """,
    "UNJITTED_BRANCH": """
        def f(x):
            if x > 0:
                return x
            return -x
    """,
}

# R005: the methods are static (set on the last line) and the ones whose
# findings sit on one line of the reference's fixture are one-liners
TORCH_VJP_OK = """
    import torch
    class F(torch.autograd.Function):
        # forward(flag, x, y) -> (x * y, x + y); setup_context saves x, y;
        # backward gives no gradient for flag (the reference's nondiff
        # argument) and one each for x and y
        def forward(flag, x, y): return x * y, x + y
        def setup_context(ctx, inputs, output): flag, x, y = inputs; ctx.save_for_backward(x, y)
        def backward(ctx, ct, ct_sum):
            x, y = ctx.saved_tensors
            return (None, ct * y + ct_sum, ct * x + ct_sum)
        forward, setup_context, backward = map(
            staticmethod, (forward, setup_context, backward))
"""
R005_FIXTURES = {
    "VJP_OK": TORCH_VJP_OK,
    "VJP_RESIDUAL_DRIFT": TORCH_VJP_OK.replace(
        "x, y = ctx.saved_tensors", "x, y, z = ctx.saved_tensors"),
    "VJP_BWD_PARAMS": TORCH_VJP_OK.replace("def backward(ctx, ct, ct_sum):",
                                           "def backward(ctx, ct):"),
    "VJP_BWD_RETURN": TORCH_VJP_OK.replace(
        "return (None, ct * y + ct_sum, ct * x + ct_sum)",
        "return (None, ct * y + ct_sum, ct * x + ct_sum, None)"),
    "VJP_FWD_PARAMS": TORCH_VJP_OK.replace("def forward(flag, x, y):",
                                           "def forward(flag, x):"),
    "VJP_FWD_RETURN": TORCH_VJP_OK.replace(
        "def setup_context(ctx, inputs, output):",
        "def setup_context(ctx, inputs):"),
}
R005_MESSAGES = {"VJP_RESIDUAL_DRIFT": "unpacks 3 tensor(s)",
                 "VJP_BWD_PARAMS": "takes 2 parameter(s), expected 3",
                 "VJP_BWD_RETURN": "returns 4 gradient(s), expected 3",
                 "VJP_FWD_PARAMS": "forward` takes 2",
                 "VJP_FWD_RETURN": "expected 3 `(ctx, inputs, output)`"}

TRANSLATED = ([("R001", n, s, R001_PATH) for n, s in R001_FIXTURES.items()]
              + [("R004", n, s, "fixture.py")
                 for n, s in R004_FIXTURES.items()]
              + [("R005", n, s, "fixture.py")
                 for n, s in R005_FIXTURES.items()])


@pytest.mark.parametrize("rule,name,src,path", TRANSLATED,
                         ids=[f"{r}-{n}" for r, n, _, _ in TRANSLATED])
def test_torch_fixture_finds_what_the_reference_finds(rule, name, src, path):
    ref_src = getattr(REF_FIXTURES, name)
    want = findings(ref_src, rule, analyze=ref_analyze)
    got = findings(src, rule, path)
    assert lines(got) == lines(want), (got, want)
    if name in R005_MESSAGES:
        assert R005_MESSAGES[name] in got[0].message
    if name == "VJP_BRANCH":
        assert "ct" in got[0].message
    if name == "CONCAT_PRAGMA":
        assert "scalars" in got[0].reason


def test_r001_is_scoped_to_the_dtensor_path():
    bad = R001_FIXTURES["CONCAT_BAD"]
    assert len(live(bad, "R001", path=R001_PATH)) == 1
    for path in ("src/repro_torch/dist/sharding.py",
                 "src/repro_torch/core/lmc.py", "fixture.py"):
        assert live(bad, "R001", path=path) == []


# ---------------------------------------------------- R005 & R004, torch only
OLD_STYLE = """
    import torch
    class G(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, idx):
            ctx.save_for_backward(idx)
            return x[idx]
        @staticmethod
        def backward(ctx, d):
            (idx,) = ctx.saved_tensors
            return d, None
"""


@pytest.mark.parametrize("mutation,count", [
    (None, 0),
    (("return d, None", "return d,"), 1),
    (("(idx,) = ctx.saved_tensors", "idx, x = ctx.saved_tensors"), 1),
    (("ctx.save_for_backward(idx)", "ctx.save_for_backward(*ctx.extra)"), 0),
    (("return d, None", "return helper(d)"), 0),
    (("def forward(ctx, x, idx):", "def forward(ctx, x, *idx):"), 0),
])
def test_r005_old_style_functions_and_computed_arity(mutation, count):
    src = OLD_STYLE if mutation is None else OLD_STYLE.replace(*mutation)
    assert len(live(src, "R005")) == count


@pytest.mark.parametrize("src,count", [
    # torch.cuda.synchronize, .cpu(), .tolist() and a cast in a Function
    ("""
    import torch
    class H(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, n):
            torch.cuda.synchronize()
            k = int(n)
            return x.cpu() * k, x.tolist()
    """, 4),
    # ctx is no tensor, and metadata / isinstance / len tests are free
    ("""
    import torch
    class H(torch.autograd.Function):
        @staticmethod
        def backward(ctx, g):
            if ctx.needs_input_grad[0] and g.dtype == torch.float32:
                return g, None
            while len(g) > 1 and isinstance(g, torch.Tensor):
                g = g[1:]
            return g.to(g.device), None
    """, 0),
    # functions handed to torch.func.vjp / checkpoint, and what they nest
    ("""
    import torch
    from torch.utils.checkpoint import checkpoint
    def body(h, m):
        def inner(z):
            return z.item()
        if m:
            return h
        return inner(h)
    def g(f):
        def fn(e):
            return e.numpy()
        out = torch.func.vjp(fn, f)
        return checkpoint(body, out, 1, use_reentrant=False)
    """, 3),
    # the step of make_lm_decode_step, returned through a wrapper
    ("""
    def make_lm_decode_step(lm, mesh):
        def decode_step(params, caches, token, length):
            while length:
                length = length - 1
            return lm.decode_step(params, caches, token, length)
        return wrap(decode_step, mesh)
    """, 1),
])
def test_r004_hot_scopes_of_the_port(src, count):
    assert len(live(src, "R004")) == count


# ------------------------------------------------------ R002 / R003 (CUDA)
CU_PRELUDE = """
    #include <cuda_runtime.h>
    __device__ __forceinline__ void cp_async16(void* s, const void* g) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s), "l"(g));
    }
"""
CU_STAGE = CU_PRELUDE + """
    __global__ void __launch_bounds__(256) k(const float* h, float* out, int M) {
      extern __shared__ __align__(16) unsigned char smem[];
      float* slab = reinterpret_cast<float*>(smem);
      for (int t = threadIdx.x; t < M; t += blockDim.x)
        cp_async16(slab + 4 * t, h + 4 * t);
      asm volatile("cp.async.wait_all;\\n" ::: "memory");
      __syncthreads();
      out[threadIdx.x] = slab[threadIdx.x];
    }
    int launch(const float* h, float* out, int M) {
      const size_t smem = static_cast<size_t>(M) * 16;
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
      k<<<1, 256, smem>>>(h, out, M);
      return 0;
    }
"""
CU_CASES = {
    "staged_ok": (CU_STAGE, {}),
    "group_wait_ok": (CU_STAGE.replace(
        'asm volatile("cp.async.wait_all;\\n" ::: "memory");',
        'asm volatile("cp.async.commit_group;\\n" ::: "memory");\n'
        '      asm volatile("cp.async.wait_group 0;\\n" ::: "memory");'), {}),
    "no_wait": (CU_STAGE.replace(
        'asm volatile("cp.async.wait_all;\\n" ::: "memory");', ""),
        {"R002": "never waited for"}),
    "wait_group_without_commit": (CU_STAGE.replace(
        'cp.async.wait_all;', 'cp.async.wait_group 0;'),
        {"R002": "never waited for"}),
    "no_sync": (CU_STAGE.replace("__syncthreads();", ""),
                {"R002": "no `__syncthreads()`"}),
    "read_before_wait": (CU_STAGE.replace(
        'asm volatile("cp.async.wait_all;\\n" ::: "memory");',
        'out[0] = slab[0];\n      asm volatile("cp.async.wait_all;\\n" '
        '::: "memory");'), {"R002": "before the cp.async wait"}),
    "store_before_sync_is_no_read": (CU_STAGE.replace(
        "__syncthreads();", "slab[0] = 1.f;\n      __syncthreads();"), {}),
    "wait_in_a_comment_only": (CU_STAGE.replace(
        'asm volatile("cp.async.wait_all;\\n" ::: "memory");',
        "// cp.async.wait_all"), {"R002": "never waited for"}),
    "mbarrier_arrive_no_wait": (CU_PRELUDE + """
    __global__ void __launch_bounds__(128) m(unsigned long long* bar) {
      asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], 16;" :: "l"(bar));
    }
    """, {"R002": "no mbarrier wait"}),
    "mbarrier_wait_no_arrive": (CU_PRELUDE + """
    __global__ void __launch_bounds__(128) m(unsigned long long* bar) {
      asm volatile("mbarrier.try_wait.parity.shared.b64 p, [%0], 0;" :: "l"(bar));
    }
    """, {"R002": "deadlocks"}),
    "mbarrier_paired": (CU_PRELUDE + """
    __global__ void __launch_bounds__(128) m(unsigned long long* bar) {
      asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], 16;" :: "l"(bar));
      asm volatile("mbarrier.try_wait.parity.shared.b64 p, [%0], 0;" :: "l"(bar));
    }
    """, {}),
    "no_launch_bounds": (CU_STAGE.replace("__launch_bounds__(256) ", ""),
                         {"R003": "no `__launch_bounds__`"}),
    "no_opt_in": (re.sub(r"cudaFuncSetAttribute\(.*?\);", "", CU_STAGE,
                         flags=re.S),
                  {"R003": "without `cudaFuncSetAttribute"}),
    "no_launcher": (CU_STAGE[:CU_STAGE.index("    int launch(")],
                    {"R003": "no host function"}),
    "constant_dynamic_over_budget": (CU_STAGE.replace(
        "k<<<1, 256, smem>>>", f"k<<<1, 256, {SMEM_OPTIN_BYTES + 16}>>>"),
        {"R003": f"over the {SMEM_OPTIN_BYTES} B"}),
    "static_under_48k": (CU_PRELUDE + """
    constexpr int kRows = 64;
    __global__ void __launch_bounds__(256) s(float* out) {
      __shared__ float tile[kRows][128];
      tile[0][threadIdx.x] = 0.f;
      __syncthreads();
      out[threadIdx.x] = tile[0][threadIdx.x];
    }
    """, {}),
    "static_over_48k": (CU_PRELUDE + """
    constexpr int kRows = 64;
    __global__ void __launch_bounds__(256) s(float* out) {
      __shared__ float tile[kRows][128];
      __shared__ __align__(16) double more[kRows * 64];
      out[threadIdx.x] = tile[0][threadIdx.x] + more[0];
    }
    """, {"R003": "sum to 65536 B"}),
    "static_unresolved": (CU_PRELUDE + """
    template <int N>
    __global__ void __launch_bounds__(256) s(float* out) {
      __shared__ float tile[N];
      out[threadIdx.x] = tile[0];
    }
    """, {"R003": "cannot evaluate"}),
}


@pytest.mark.parametrize("name", sorted(CU_CASES))
def test_cuda_rules_on_fixtures(name):
    src, want = CU_CASES[name]
    fs = [f for f in findings(src, path="fixture.cu") if not f.suppressed]
    got = {f.rule for f in fs if f.rule in ("R002", "R003")}
    assert got == set(want), [f.format() for f in fs]
    for rule, text in want.items():
        assert any(text in f.message for f in fs if f.rule == rule), \
            [f.format() for f in fs]


def test_cuda_pragma_is_a_line_comment():
    src = CU_CASES["no_sync"][0].replace(
        "      out[threadIdx.x] = slab[threadIdx.x];",
        "      // lint: ok(R002) fixture: one thread staged everything\n"
        "      out[threadIdx.x] = slab[threadIdx.x];")
    (f,) = [f for f in findings(src, "R002", path="fixture.cu")]
    assert f.suppressed and "one thread" in f.reason
    bare = src.replace(" fixture: one thread staged everything", "")
    fs = findings(bare, path="fixture.cu")
    assert any(f.rule == "R000" and "//" in f.message for f in fs)
    assert any(f.rule == "R002" and not f.suppressed for f in fs)


# --------------------------------------------- mutations of the port's files
def _drop(pattern):
    def mutate(s):
        out = re.sub(pattern, "", s, count=1, flags=re.S)
        assert out != s, pattern
        return out
    return mutate


def _swap(old, new):
    def mutate(s):
        assert old in s, old
        return s.replace(old, new, 1)
    return mutate


MUTATIONS = {
    "R002-compensate.cu-no-wait": (
        "csrc/compensate.cu", "R002",
        _drop(r'\s*asm volatile\("cp\.async\.wait_all;\\n" ::: "memory"\);')),
    "R002-ell_spmm.cu-no-sync": (
        "csrc/ell_spmm.cu", "R002", _swap("  __syncthreads();\n", "\n")),
    "R003-ell_spmm.cu-no-opt-in": (
        "csrc/ell_spmm.cu", "R003",
        _drop(r"\s*const cudaError_t e = cudaFuncSetAttribute\(.*?;"
              r"\s*if \(e != cudaSuccess\) return e;")),
    "R003-compensate.cu-no-launch-bounds": (
        "csrc/compensate.cu", "R003",
        _swap("__global__ void __launch_bounds__(kResWarps * 32, 1)",
              "__global__ void")),
    "R003-ell_spmm.py-unbounded-slab": (
        "kernels/ell_spmm.py", "R003",
        _swap("args.append(slab_cols(m, d, h.element_size(),\n"
              "                              smem_optin(h.device.index or 0)))",
              "args.append(d)")),
    "R004-lmc.py-item-in-step": (
        "core/lmc.py", "R004",
        _swap("inv_vl = batch.loss_scale / batch.grad_scale",
              "inv_vl = batch.loss_scale.item() / batch.grad_scale")),
    "R005-ops.py-saved-tensor": (
        "kernels/ops.py", "R005",
        _swap("ctx.save_for_backward(store, gids, beta, fresh, mask)",
              "ctx.save_for_backward(store, gids, beta, fresh, mask, beta)")),
    "R006-prefetch.py-unbounded": (
        "data/prefetch.py", "R006",
        _swap("queue.Queue(maxsize=depth)", "queue.Queue()")),
    "R001-layers.py-raw-cat": (
        "models/layers.py", "R001", _swap("concat_rows(", "torch.cat(")),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_each_rule_fires_on_a_broken_copy_of_a_real_file(name, tmp_path):
    rel, rule, mutate = MUTATIONS[name]
    # the copy keeps the port's layout: R001/R006 are scoped by directory
    target = tmp_path / "repro_torch" / rel
    target.parent.mkdir(parents=True, exist_ok=True)
    source = (PORT / rel).read_text()
    target.write_text(source)

    def live_of(path):
        return [f for f in run_analysis([path]) if f.rule == rule
                and not f.suppressed]
    assert live_of(target) == []
    target.write_text(mutate(source))
    assert live_of(target), f"{rule} did not fire on the mutated {rel}"


# ----------------------------------------------------- catalog, CLI, self-host
def test_rule_catalog_ids_unique_and_documented():
    rules = all_rules()
    ids = [r.id for r in rules]
    assert ids == sorted(set(ids)) == ["R001", "R002", "R003", "R004",
                                       "R005", "R006"]
    assert all(r.name and r.doc for r in rules)
    assert {r.id for r in rules if "cu" in r.languages} == {"R002", "R003"}


def test_self_hosted_port_is_clean():
    """The standing guarantee: zero unsuppressed findings over the port and
    chip_smoke.py, with the kept sites present as reasoned pragmas and the
    CUDA sources actually read."""
    fs = run_analysis([PORT, CHIP_SMOKE])
    bad = [f for f in fs if not f.suppressed]
    assert bad == [], "\n" + "\n".join(f.format() for f in bad)
    assert any(f.rule == "R001" and f.suppressed for f in fs)
    assert any(f.rule == "R004" and f.suppressed for f in fs)
    from repro_torch.analysis.rules_cuda import CudaSource
    kernels = [f.name for cu in sorted((PORT / "csrc").glob("*.cu"))
               for f in CudaSource(cu.read_text()).functions
               if f.kind == "global"]
    assert sorted(kernels) == ["compensate_kernel",
                               "compensate_resident_kernel",
                               "ell_build_kernel", "ell_rows_kernel",
                               "ell_spmm_kernel",
                               "ell_spmm_resident_kernel"]


def test_summary_has_per_rule_lines():
    out = summarize(run_analysis([PORT, CHIP_SMOKE]))
    for rid in ("R001", "R002", "R003", "R004", "R005", "R006"):
        assert rid in out
    assert "repro_torch.analysis: 0 unsuppressed" in out


@pytest.mark.parametrize("args,rc,text", [
    ((), 0, "0 unsuppressed finding"),
    ((PORT, CHIP_SMOKE), 0, "0 unsuppressed finding"),
    (("--rule", "R999", PORT), 2, "unknown rule"),
    (("--bogus-flag",), 2, "usage"),
])
def test_cli_exit_codes(args, rc, text):
    res = cli(*args)
    assert res.returncode == rc, res.stdout + res.stderr
    assert text in res.stdout + res.stderr


def test_cli_exit_1_rule_filter_and_json(tmp_path):
    bad = tmp_path / "repro_torch" / "models" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(textwrap.dedent(R001_FIXTURES["CONCAT_BAD"]))
    res = cli(bad)
    assert res.returncode == 1 and "R001" in res.stdout
    res = cli("--rule", "R002", bad)
    assert res.returncode == 0            # an R001 site, but only R002 run
    res = cli("--json", bad)
    assert res.returncode == 1
    data = json.loads(res.stdout)
    assert [f["rule"] for f in data] == ["R001"]
    assert "unsuppressed" in res.stderr
    res = cli("--show-suppressed", PORT / "models" / "blocks.py")
    assert res.returncode == 0 and "[suppressed:" in res.stdout
