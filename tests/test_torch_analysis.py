"""The port's static-analysis engine (``repro_torch.analysis``) against the
reference's (``repro.analysis``): equal findings and fingerprints from the
eight rules both share, over both trees and over the reference's own
fixture snippets; a positive and a negative fixture for each rule pointed
at the port (``timing-warmup``, ``rng-unseeded``, ``registry-roundtrip``,
``kernel-launch``, ``kernel-smem``); the baseline machinery and both
committed baselines; and the port's strict gate."""
import json
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch

torch.set_num_threads(1)

import repro.analysis as ref  # noqa: E402
import repro_torch.analysis as port  # noqa: E402
from repro_torch.analysis.core import Suppression  # noqa: E402
from repro_torch.analysis.rules_kernel import audit_smem_budgets  # noqa: E402
from repro_torch.analysis.rules_schema import check_registries  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_BASELINE = ROOT / "src" / "repro_torch" / "analysis" / "baseline.json"

# the rules both engines carry unchanged
SHARED = ["timing-monotonic-accum", "rng-reset", "socket-shutdown",
          "thread-lifecycle", "schema-version", "broad-except", "syntax",
          "suppression-justification"]
TREES = ["src/repro", "benchmarks", "examples", "src/repro_torch",
         "chip_smoke.py"]


def prints(findings):
    return [(f.rule, f.path, f.line, f.key, f.suppressed) for f in findings]


def rules_of(findings):
    return {f.rule for f in findings}


def waivers(ctx):
    return [(s.path, s.line, s.rules, s.justification)
            for f in ctx.files for s in f.suppressions()]


# ---------------------------------------------------------------------------
# parity over the trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", TREES)
def test_shared_rules_equal_over_each_tree(tree):
    ctx_ref = ref.load_context([tree], ROOT, runtime=False)
    ctx_port = port.load_context([tree], ROOT, runtime=False)
    assert [f.path for f in ctx_ref.files] == [f.path for f in ctx_port.files]
    assert ctx_port.files
    got = prints(port.run_rules(ctx_port, rules=SHARED))
    assert got == prints(ref.run_rules(ctx_ref, rules=SHARED))
    assert waivers(ctx_port) == waivers(ctx_ref)
    if tree in ("src/repro", "src/repro_torch"):
        # both trees carry justified broad-except waivers: the comparison
        # holds real findings, not two empty lists
        assert any(r == "broad-except" and sup for r, _, _, _, sup in got)


# ---------------------------------------------------------------------------
# parity over the reference's fixture snippets (tests/test_analysis.py)
# ---------------------------------------------------------------------------

TIMING_POS = """
import time
import jax

def measure(fn, x, n):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        ts.append(time.perf_counter() - t0)
    return ts
"""

TIMING_NEG = """
import time
import jax

def measure(fn, x, n):
    for _ in range(3):
        jax.block_until_ready(fn(x))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        ts.append(time.perf_counter() - t0)
    return ts
"""

ACCUM_POS = """
import time

def run_load(period, n, send):
    t = time.monotonic()
    for _ in range(n):
        t += period
        send(t)
"""

ACCUM_NEG = """
import time

def run_load(period, n, send):
    t_start = time.monotonic()
    for i in range(n):
        send(t_start + i * period)
"""

RNG_RESET_POS = """
import numpy as np

class Link:
    def __init__(self, seed):
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._busy_until = 0.0

    def reset(self):
        self._busy_until = 0.0
"""

RNG_RESET_NEG = RNG_RESET_POS.replace(
    "    def reset(self):\n        self._busy_until = 0.0",
    "    def reset(self):\n"
    "        self._busy_until = 0.0\n"
    "        self._rng = np.random.default_rng(self.seed)",
)

RNG_UNSEEDED_POS = """
import numpy as np

def jitter():
    rng = np.random.default_rng()
    return np.random.uniform(0.0, 1.0)
"""

RNG_UNSEEDED_NEG = """
import numpy as np

def jitter(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0)
"""

SOCKET_POS = """
import socket

def talk(addr):
    s = socket.create_connection(addr)
    s.sendall(b"x")
    s.close()
"""

SOCKET_NEG = """
import socket

def talk(addr):
    s = socket.create_connection(addr)
    s.sendall(b"x")
    s.shutdown(socket.SHUT_RDWR)
    s.close()
"""

SOCKET_LISTENER = """
import socket

def serve():
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen()
    listener.close()
"""

THREAD_POS = """
import threading

def go(fn):
    t = threading.Thread(target=fn)
    t.start()
    return t
"""

THREAD_JOINED = """
import threading

def go(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join()
"""

THREAD_DAEMON = """
import threading

def go(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
"""

PROCESS_DAEMON = """
import multiprocessing

def go(fn):
    p = multiprocessing.Process(target=fn, daemon=True)
    p.start()
"""

SCHEMA_POS = """
import dataclasses

@dataclasses.dataclass(frozen=True)
class Cfg:
    x: int = 1

    def to_dict(self):
        return {"x": self.x}

    @classmethod
    def from_dict(cls, d):
        return cls(**d)
"""

SCHEMA_NEG = """
import dataclasses

CFG_VERSION = 1

@dataclasses.dataclass(frozen=True)
class Cfg:
    x: int = 1

    def to_dict(self):
        return {"version": CFG_VERSION, "x": self.x}

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        version = d.pop("version", CFG_VERSION)
        if version != CFG_VERSION:
            raise ValueError(f"unsupported version {version}")
        return cls(**d)
"""

REGISTRY_POS = """
from repro.serving.fleet import register_router

register_router("definitely-not-a-registered-router", lambda *a: 0)
"""

REGISTRY_NEG = """
from repro.serving.fleet import register_router

register_router("round_robin", lambda *a: 0)
"""

INTERPRET_POS = """
import jax.experimental.pallas as pl

def launch(kernel, x, shape):
    return pl.pallas_call(kernel, out_shape=shape)(x)
"""

INTERPRET_NEG = """
import jax.experimental.pallas as pl

def launch(kernel, x, shape, interpret):
    return pl.pallas_call(kernel, out_shape=shape, interpret=interpret)(x)
"""

EXCEPT_POS = """
def f():
    try:
        g()
    except Exception:
        pass
"""

EXCEPT_NEG_NARROW = """
def f():
    try:
        g()
    except (ValueError, KeyError):
        pass
"""

EXCEPT_NEG_RERAISE = """
def f():
    try:
        g()
    except Exception:
        cleanup()
        raise
"""

EXCEPT_SUPPRESSED = """
def f():
    try:
        g()
    except Exception:  # repro: allow(broad-except) -- probe: any failure means unsupported
        pass
"""

EXCEPT_NO_JUSTIFICATION = """
def f():
    try:
        g()
    except Exception:  # repro: allow(broad-except)
        pass
"""

EXCEPT_DOCSTRING = ('"""# repro: allow(broad-except) -- not a real comment"""\n'
                    + EXCEPT_POS)

# name -> (snippet, the shared rules it must fire)
FIXTURES = {
    "timing_pos": (TIMING_POS, set()),
    "timing_neg": (TIMING_NEG, set()),
    "accum_pos": (ACCUM_POS, {"timing-monotonic-accum"}),
    "accum_neg": (ACCUM_NEG, set()),
    "rng_reset_pos": (RNG_RESET_POS, {"rng-reset"}),
    "rng_reset_neg": (RNG_RESET_NEG, set()),
    "rng_unseeded_pos": (RNG_UNSEEDED_POS, set()),
    "rng_unseeded_neg": (RNG_UNSEEDED_NEG, set()),
    "socket_pos": (SOCKET_POS, {"socket-shutdown"}),
    "socket_neg": (SOCKET_NEG, set()),
    "socket_listener": (SOCKET_LISTENER, set()),
    "thread_pos": (THREAD_POS, {"thread-lifecycle"}),
    "thread_joined": (THREAD_JOINED, set()),
    "thread_daemon": (THREAD_DAEMON, set()),
    "process_daemon": (PROCESS_DAEMON, {"thread-lifecycle"}),
    "schema_pos": (SCHEMA_POS, {"schema-version"}),
    "schema_neg": (SCHEMA_NEG, set()),
    "schema_plain_class": (
        SCHEMA_POS.replace("@dataclasses.dataclass(frozen=True)\n", ""),
        set()),
    "registry_pos": (REGISTRY_POS, set()),
    "registry_neg": (REGISTRY_NEG, set()),
    "interpret_pos": (INTERPRET_POS, set()),
    "interpret_neg": (INTERPRET_NEG, set()),
    "except_pos": (EXCEPT_POS, {"broad-except"}),
    "except_narrow": (EXCEPT_NEG_NARROW, set()),
    "except_reraise": (EXCEPT_NEG_RERAISE, set()),
    "except_suppressed": (EXCEPT_SUPPRESSED, {"broad-except"}),
    "except_no_justification": (
        EXCEPT_NO_JUSTIFICATION,
        {"broad-except", "suppression-justification"}),
    "except_docstring": (EXCEPT_DOCSTRING, {"broad-except"}),
    "syntax_pos": ("def f(:\n", {"syntax"}),
    "syntax_neg": ("x = 1\n", set()),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_shared_rules_equal_on_reference_fixtures(name):
    src, want = FIXTURES[name]
    got = port.analyze_source(src, rules=SHARED)
    assert prints(got) == prints(ref.analyze_source(src, rules=SHARED))
    assert [f.justification for f in got] == [
        f.justification for f in ref.analyze_source(src, rules=SHARED)]
    assert rules_of(got) == want
    sf = port.SourceFile("snippet.py", src, None)
    rsf = ref.SourceFile("snippet.py", src, None)
    assert [(s.line, s.rules, s.justification) for s in sf.suppressions()] \
        == [(s.line, s.rules, s.justification) for s in rsf.suppressions()]


# ---------------------------------------------------------------------------
# timing-warmup: torch's synchronizations
# ---------------------------------------------------------------------------

TORCH_TIMING_POS = """
import time
import torch

def measure(fn, x, n):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return ts
"""

TORCH_TIMING_NEG = """
import time
import torch

def measure(fn, x, n):
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return ts
"""

TIMING_NESTED_SYNC = """
import time
import torch

def measure(fn, x):
    def warm():
        fn(x)
        torch.cuda.synchronize()

    warm()
    t0 = time.perf_counter()
    fn(x)
    torch.cuda.synchronize()
    return time.perf_counter() - t0
"""


def test_timing_warmup_torch_positive():
    f = port.analyze_source(TORCH_TIMING_POS, rules=["timing-warmup"])
    assert rules_of(f) == {"timing-warmup"}
    assert "synchronize" in f[0].message and "jax" not in f[0].message


@pytest.mark.parametrize("sync", [
    "torch.cuda.synchronize()", "end.synchronize()",
    "torch.cuda.current_stream().synchronize()", "_block(out)",
    "self._sync()", "_sync()"])
def test_timing_warmup_torch_syncs_count(sync):
    src = TORCH_TIMING_NEG.replace("    torch.cuda.synchronize()\n    ts",
                                   f"    {sync}\n    ts", 1)
    assert sync in src
    assert port.analyze_source(src, rules=["timing-warmup"]) == []


def test_timing_warmup_sync_in_nested_helper_does_not_count():
    f = port.analyze_source(TIMING_NESTED_SYNC, rules=["timing-warmup"])
    assert rules_of(f) == {"timing-warmup"}


def test_timing_warmup_jax_block_is_not_a_torch_sync():
    # the port has no jax: a block_until_ready there waits for nothing
    f = port.analyze_source(TIMING_NEG, rules=["timing-warmup"])
    assert rules_of(f) == {"timing-warmup"}
    assert ref.analyze_source(TIMING_NEG, rules=["timing-warmup"]) == []


# ---------------------------------------------------------------------------
# rng-unseeded: the port's serving modules, numpy and torch draws
# ---------------------------------------------------------------------------

PORT_SERVING = "src/repro_torch/serving/fake_link.py"

TORCH_DRAW = """
import torch

def jitter(n, gen):
    return {draw}
"""


def test_rng_unseeded_numpy_positive_in_port_scope():
    f = port.analyze_source(RNG_UNSEEDED_POS, path=PORT_SERVING,
                            rules=["rng-unseeded"])
    assert len(f) == 2 and rules_of(f) == {"rng-unseeded"}


def test_rng_unseeded_numpy_negative_in_port_scope():
    assert port.analyze_source(RNG_UNSEEDED_NEG, path=PORT_SERVING,
                               rules=["rng-unseeded"]) == []


@pytest.mark.parametrize("path", ["src/repro/serving/fake_link.py",
                                  "src/repro_torch/examples/demo.py"])
def test_rng_unseeded_out_of_scope(path):
    src = RNG_UNSEEDED_POS + TORCH_DRAW.format(draw="torch.rand(n)")
    assert port.analyze_source(src, path=path, rules=["rng-unseeded"]) == []


@pytest.mark.parametrize("draw", [
    "torch.rand(n)", "torch.randn(n, 2)", "torch.randint(0, 9, (n,))",
    "torch.randperm(n)", "torch.normal(0.0, 1.0, (n,))",
    "torch.bernoulli(torch.full((n,), 0.5))",
    "torch.rand(n, generator=None)"])
def test_rng_unseeded_torch_global_draw_positive(draw):
    f = port.analyze_source(TORCH_DRAW.format(draw=draw), path=PORT_SERVING,
                            rules=["rng-unseeded"])
    assert rules_of(f) == {"rng-unseeded"} and len(f) == 1
    assert "generator" in f[0].message


@pytest.mark.parametrize("draw", [
    "torch.rand(n, generator=gen)", "torch.randperm(n, generator=gen)",
    "torch.normal(0.0, 1.0, (n,), generator=gen)", "torch.zeros(n)"])
def test_rng_unseeded_torch_generator_draw_negative(draw):
    assert port.analyze_source(TORCH_DRAW.format(draw=draw),
                               path=PORT_SERVING,
                               rules=["rng-unseeded"]) == []


# ---------------------------------------------------------------------------
# registry-roundtrip: the port's registries
# ---------------------------------------------------------------------------

def _port_registries():
    from repro_torch.core.backends import backend_names
    from repro_torch.serving.fleet import ROUTERS
    from repro_torch.serving.netsim import LINK_KINDS
    from repro_torch.serving.profiles import DEVICE_PROFILES
    from repro_torch.serving.scenario import ADAPTATIONS, SCENARIOS
    return {
        "register_router": ("repro_torch.serving.fleet", list(ROUTERS)),
        "register_link_kind": ("repro_torch.serving.netsim",
                               list(LINK_KINDS)),
        "register_scenario": ("repro_torch.serving.scenario",
                              list(SCENARIOS)),
        "register_adaptation": ("repro_torch.serving.scenario",
                                list(ADAPTATIONS)),
        "register_profile": ("repro_torch.serving.profiles",
                             list(DEVICE_PROFILES)),
        "register_backend": ("repro_torch.core.backends",
                             list(backend_names())),
    }


REGISTER = """
from somewhere import {fn}

{fn}("{name}", lambda *a: 0)
"""


def test_registry_roundtrip_positive_against_the_port():
    src = REGISTRY_POS.replace("repro.serving", "repro_torch.serving") \
        .replace("definitely-not-a-registered-router", "no-such-router")
    f = port.analyze_source(src, rules=["registry-roundtrip"])
    assert rules_of(f) == {"registry-roundtrip"}
    assert "no-such-router" in f[0].message
    assert "repro_torch.serving.fleet" in f[0].message


def test_registry_roundtrip_negative_against_the_port():
    assert port.analyze_source(REGISTRY_NEG, rules=["registry-roundtrip"]) \
        == []


@pytest.mark.parametrize("fn", sorted(_port_registries()))
def test_every_register_maps_to_the_port_registry(fn):
    module, names = _port_registries()[fn]
    assert names
    bad = port.analyze_source(REGISTER.format(fn=fn, name="no-such-entry"),
                              rules=["registry-roundtrip"])
    assert len(bad) == 1 and module in bad[0].message
    assert port.analyze_source(REGISTER.format(fn=fn, name=names[0]),
                               rules=["registry-roundtrip"]) == []


def test_live_port_registries_are_clean():
    assert check_registries() == []


# ---------------------------------------------------------------------------
# kernel-launch
# ---------------------------------------------------------------------------

LAUNCH_OK = """
import torch
from repro_torch.kernels._build import check_rc, launcher

def run(x, dev):
    fn = launcher("lib", "sym")
    rc = fn(x.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_rc(rc, "sym")
"""

LAUNCH_HELPER = """
import torch
from repro_torch.kernels._build import check_rc, launcher

_fns = {}


def _fn(k):
    fn = _fns.get(k)
    if fn is None:
        fn = _fns[k] = launcher("lib", "sym")
    return fn


def _outer(k):
    return _fn(k)


def run(x, index):
    check_rc(_outer(0)(x.data_ptr(),
                       torch._C._cuda_getCurrentRawStream(index)), "sym")
"""


def test_kernel_launch_negative():
    assert port.analyze_source(LAUNCH_OK, rules=["kernel-launch"]) == []
    assert port.analyze_source(LAUNCH_HELPER, rules=["kernel-launch"]) == []


@pytest.mark.parametrize("src,what", [
    (LAUNCH_OK.replace('    check_rc(rc, "sym")\n', ""), "cudaError_t"),
    (LAUNCH_OK.replace('check_rc(rc, "sym")', 'check_rc(0, "sym")'),
     "cudaError_t"),
    (LAUNCH_OK.replace("torch.cuda.current_stream(dev).cuda_stream", "0"),
     "stream"),
    (LAUNCH_HELPER.replace("check_rc(_outer", "print(_outer"),
     "cudaError_t"),
    (LAUNCH_HELPER.replace("torch._C._cuda_getCurrentRawStream(index)",
                           "0"), "stream"),
])
def test_kernel_launch_positive(src, what):
    f = port.analyze_source(src, rules=["kernel-launch"])
    assert rules_of(f) == {"kernel-launch"} and len(f) == 1
    assert what in f[0].message and "run()" in f[0].message


KERNELS = ROOT / "src" / "repro_torch" / "kernels"
# the one launch site: every wrapper reaches the card through it
SITES = {"_build.py": ("launch",)}
# the modules that launch, through SITES
LAUNCHING = ("_build.py", "miniconv_pass.py", "flash_attention.py",
             "moe_grouped.py", "ssd_scan.py")
# (file, source edit, the function whose launch it breaks, message part)
MUTATIONS = [
    ("_build.py", ("check_rc(fn(", "print(fn("), "launch", "cudaError_t"),
    ("_build.py", ("torch._C._cuda_getCurrentRawStream(index)", "0"),
     "launch", "stream"),
]


@pytest.mark.parametrize("name", LAUNCHING)
def test_kernel_launch_real_sites_are_clean(name):
    src = (KERNELS / name).read_text()
    path = f"src/repro_torch/kernels/{name}"
    assert port.analyze_source(src, path=path, rules=["kernel-launch"]) == []


@pytest.mark.parametrize("case", range(len(MUTATIONS)))
def test_kernel_launch_sees_each_real_site(case):
    """A real site with its rc dropped or its stream read removed fires:
    the clean result above is the rule seeing the site, not missing it."""
    name, (old, new), fn, what = MUTATIONS[case]
    assert fn in SITES[name]
    src = (KERNELS / name).read_text()
    assert src.count(old) == 1
    f = port.analyze_source(src.replace(old, new), rules=["kernel-launch"])
    assert len(f) == 1 and f"{fn}()" in f[0].message and what in f[0].message


@pytest.mark.parametrize("library", sorted(_build.SOURCES))
def test_each_library_has_one_launch_entry(library):
    """The C half of ``_build.launch``: a library exports one entry,
    ``<library>_launch(const long long* a)``, and its ``enum Arg`` ends in
    the device and stream slots that ``launch`` appends."""
    src = (KERNELS / "csrc" / _build.SOURCES[library]).read_text()
    assert src.count('extern "C"') == 1
    assert re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src) == [
        (f"{library}_launch", "const long long* a")]
    enum = re.search(r"enum Arg \{(.*?)\};", src, re.S).group(1)
    members = [m.split("=")[0].strip()
               for m in re.sub(r"//[^\n]*", "", enum).split(",")]
    assert members[-3:] == ["kDevice", "kStream", "kNArgs"]


# ---------------------------------------------------------------------------
# kernel-smem
# ---------------------------------------------------------------------------

def _smem_backends():
    from repro_torch.core.backends import backend_names, get_backend
    return [n for n in backend_names()
            if get_backend(n).mode in ("fused", "grouped")]


def test_smem_audit_clean_at_the_default_limit():
    # the card has no VMEM budget: K1 and K4 tile, and every standard
    # config's smallest tile and grouped's staged weights fit
    assert audit_smem_budgets() == []


def test_smem_audit_tiny_limit_fires_for_each_backend():
    findings = audit_smem_budgets(smem_limit=1024)
    assert findings and rules_of(findings) == {"kernel-smem"}
    assert {f.path for f in findings} == {"src/repro_torch/core/backends.py"}
    names = _smem_backends()
    assert set(names) >= {"grouped", "fused", "fused+head", "fused+stream"}
    for name in names:
        assert any(f"backend {name!r}" in f.message for f in findings), name


def test_smem_audit_is_plan_tiles_refusal():
    """At K1's own residency the fused backends that do not stream pass
    and ``fused+stream`` (K4 holds two input buffers) fails; one byte
    below, all three fail — where ``plan_tiles`` itself would refuse."""
    from repro_torch.core.miniconv import standard_spec
    from repro_torch.core.passplan import (SMEM_STATIC, build_pass_plan,
                                           tile_layout)
    plans = [build_pass_plan(standard_spec(c_in=c), s, s)
             for c, s in ((12, 84), (4, 64), (4, 128), (4, 256), (4, 400))]
    k1 = max(tile_layout(p, 1, 1, False, False).smem_bytes for p in plans) \
        + SMEM_STATIC
    k4 = max(tile_layout(p, 1, 1, True, False).smem_bytes for p in plans) \
        + SMEM_STATIC
    assert k4 > k1
    at = {f.message.split("'")[1] for f in audit_smem_budgets(k1)
          if "K1" in f.message or "K4" in f.message}
    assert at == {"fused+stream"}
    below = {f.message.split("'")[1] for f in audit_smem_budgets(k1 - 1)
             if "K1" in f.message or "K4" in f.message}
    assert below == {"fused", "fused+head", "fused+stream"}


# ---------------------------------------------------------------------------
# baseline machinery
# ---------------------------------------------------------------------------

def test_baseline_roundtrip_and_diff(tmp_path):
    old = port.analyze_source(EXCEPT_POS, rules=["broad-except"])
    path = tmp_path / "baseline.json"
    port.save_baseline(path, old, [])
    baseline = port.load_baseline(path)
    new_src = (EXCEPT_POS + "\n\ndef h():\n    try:\n        g()\n"
               "    except Exception:\n        return None\n")
    live = port.analyze_source(new_src, rules=["broad-except"])
    new, known, stale = port.diff_against_baseline(live, baseline)
    assert len(known) == 1 and len(new) == 1 and stale == []
    new2, known2, stale2 = port.diff_against_baseline([], baseline)
    assert new2 == [] and known2 == [] and len(stale2) == 1
    # the same file reads the same under the reference's engine
    assert ref.load_baseline(path) == baseline
    assert [f.fingerprint for f in live] == [
        f.fingerprint
        for f in ref.analyze_source(new_src, rules=["broad-except"])]


def test_baseline_unknown_version_refused(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 99, "findings": []}))
    with pytest.raises(ValueError, match="version"):
        port.load_baseline(path)


def test_baseline_unjustified_suppression_is_a_problem(tmp_path):
    path = tmp_path / "baseline.json"
    port.save_baseline(path, [], [
        Suppression("a.py", 3, ("broad-except",), ""),
        Suppression("b.py", 7, ("rng-reset",), "real reason")])
    problems = port.baseline_problems(port.load_baseline(path))
    assert len(problems) == 1 and "a.py:3" in problems[0]


@pytest.mark.parametrize("engine", [ref, port], ids=["repro", "repro_torch"])
@pytest.mark.parametrize("path", [ROOT / "analysis_baseline.json",
                                  PORT_BASELINE],
                         ids=["reference_baseline", "port_baseline"])
def test_committed_baselines_load_under_both_engines(engine, path):
    baseline = engine.load_baseline(path)
    assert baseline["version"] == engine.BASELINE_VERSION == 1
    assert engine.baseline_problems(baseline) == []


def test_port_baseline_holds_the_live_waivers_and_no_finding():
    baseline = port.load_baseline(PORT_BASELINE)
    assert baseline["findings"] == []
    ctx = port.load_context(["src/repro_torch", "chip_smoke.py"], ROOT,
                            runtime=False)
    live = sorted((p, tuple(r), j) for p, _, r, j in waivers(ctx))
    assert live == sorted((s["path"], tuple(s["rules"]), s["justification"])
                          for s in baseline["suppressions"])


# ---------------------------------------------------------------------------
# the registry and the gate
# ---------------------------------------------------------------------------

def test_all_rules_have_fixture_coverage():
    covered = {
        "timing-warmup",
        "timing-monotonic-accum",
        "rng-reset",
        "rng-unseeded",
        "socket-shutdown",
        "thread-lifecycle",
        "schema-version",
        "registry-roundtrip",
        "kernel-launch",
        "kernel-smem",
        "broad-except",
        "syntax",
        "suppression-justification",
    }
    assert set(port.rule_names()) == covered
    assert set(SHARED) <= set(ref.rule_names())
    assert port.RULES is not ref.RULES


def test_port_is_strict_clean(monkeypatch, capsys):
    from repro_torch.analysis.__main__ import DEFAULT_PATHS, main
    assert DEFAULT_PATHS == ("src/repro_torch", "chip_smoke.py")
    monkeypatch.chdir(ROOT)
    assert main(["--strict"]) == 0
    assert "strict: 0 new, 0 baselined" in capsys.readouterr().out
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert len(listed) == 13
    assert any(line.startswith("kernel-launch ") for line in listed)
    assert any(line.startswith("kernel-smem ") for line in listed)
