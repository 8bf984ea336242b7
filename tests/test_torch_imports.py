"""Import hygiene of the port: no JAX, no JAX package.

`src/repro_torch/` and `chip_smoke.py` must run on a machine without
JAX, and keep their own copies of what they need from `repro`.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")
#: the LM-scale study's modules, each imported alone below
STUDY_MODULES = ("repro_torch.configs", "repro_torch.launch.roofline",
                 "repro_torch.launch.unit_programs",
                 "repro_torch.launch.dryrun",
                 "repro_torch.core.hybrid_schedule",
                 "repro_torch.launch.lm_scale")
#: the analytic plane's modules (the paper's traces, decision function,
#: simulators, sweeps and balancer), each imported alone below too
PAPER_PLANE_MODULES = ("repro_torch.units", "repro_torch.core.units",
                       "repro_torch.core.workloads",
                       "repro_torch.core.topology", "repro_torch.core.mapper",
                       "repro_torch.core.traffic",
                       "repro_torch.core.collectives",
                       "repro_torch.core.workloads_llm",
                       "repro_torch.core.wireless", "repro_torch.net.channel",
                       "repro_torch.net.mac", "repro_torch.net.config",
                       "repro_torch.net.stack", "repro_torch.net.batched",
                       "repro_torch.core.simulator", "repro_torch.core.dse",
                       "repro_torch.core.balancer",
                       "repro_torch.launch.wireless_dse",
                       "repro_torch.launch.paper_plane")
#: the event-driven and fault planes' modules, each imported alone too
EVENT_PLANE_MODULES = ("repro_torch.sim", "repro_torch.sim.calendar",
                       "repro_torch.sim.engine", "repro_torch.sim.policies",
                       "repro_torch.sim.compare", "repro_torch.fault",
                       "repro_torch.fault.scenario",
                       "repro_torch.fault.apply",
                       "repro_torch.fault.resilience",
                       "repro_torch.launch.resilience",
                       "repro_torch.launch.event_plane")
#: the observability and heterogeneous-package planes' modules, each
#: imported alone too
OBS_ARCH_MODULES = ("repro_torch.obs", "repro_torch.obs.trace",
                    "repro_torch.obs.profile", "repro_torch.obs.provenance",
                    "repro_torch.obs.metrics", "repro_torch.obs.export",
                    "repro_torch.obs.critpath", "repro_torch.obs.whatif",
                    "repro_torch.arch", "repro_torch.arch.catalog",
                    "repro_torch.arch.package", "repro_torch.arch.placement",
                    "repro_torch.launch.trace_inspect",
                    "repro_torch.launch.whatif",
                    "repro_torch.launch.obs_plane")
#: the last slice: the linter, the bench observatory and its front ends,
#: the paper's platform config, each imported alone too
TOOLING_MODULES = ("repro_torch.lint", "repro_torch.lint.base",
                   "repro_torch.lint.registry", "repro_torch.lint.cli",
                   "repro_torch.lint.__main__",
                   "repro_torch.lint.rules_units",
                   "repro_torch.lint.rules_determinism",
                   "repro_torch.lint.rules_trace",
                   "repro_torch.lint.rules_config", "repro_torch.obs.report",
                   "repro_torch.launch.history",
                   "repro_torch.launch.observatory",
                   "repro_torch.configs.paper_accel")
REF_ROOT = REPO / "src" / "repro"
PORT_ROOT = REPO / "src" / "repro_torch"
#: the JAX package's Pallas kernel files -> their ports (the wrapper that
#: launches the kernel, and its CUDA source); every other module of the
#: JAX package has a counterpart at the same relative path
PALLAS_PORTS = {
    "kernels/flash_attention/flash_attention.py": (
        "kernels/flash_attention/ops.py", "kernels/csrc/flash_attention.cu"),
    "kernels/rmsnorm/rmsnorm.py": ("kernels/rmsnorm/ops.py",
                                   "kernels/csrc/rmsnorm.cu"),
    "kernels/ssd/ssd.py": ("kernels/ssd/ops.py", "kernels/csrc/ssd.cu"),
}


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_no_jax_and_no_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = ("import sys, pkgutil, importlib\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch\n"
            "for info in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(info.name)\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module", STUDY_MODULES + PAPER_PLANE_MODULES
                         + EVENT_PLANE_MODULES + OBS_ARCH_MODULES
                         + TOOLING_MODULES)
def test_study_module_imports_alone_with_jax_and_repro_blocked(module):
    code = ("import sys, importlib\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            f"importlib.import_module({module!r})\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_every_reference_module_has_a_counterpart():
    """The port does everything the JAX package does: each of its modules
    has a counterpart at the same relative path, and each Pallas kernel
    file its wrapper and CUDA source."""
    ref = sorted(p.relative_to(REF_ROOT).as_posix()
                 for p in REF_ROOT.rglob("*.py"))
    assert set(PALLAS_PORTS) <= set(ref)
    missing = [rel for rel in ref
               if not all((PORT_ROOT / c).is_file()
                          for c in PALLAS_PORTS.get(rel, (rel,)))]
    assert missing == []
    assert not any((PORT_ROOT / rel).exists() for rel in PALLAS_PORTS)


def test_core_re_exports_the_event_plane_lazily():
    """`repro_torch.core` resolves the `sim` and `arch` names on first
    use, and `repro_torch.core.hybrid_schedule` still imports alone
    without pulling in `sim` or `fault`."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.core.hybrid_schedule\n"
            "assert 'repro_torch.sim' not in sys.modules\n"
            "import repro_torch.core as core\n"
            "assert 'repro_torch.sim' not in sys.modules\n"
            "import repro_torch.fault\n"
            "assert 'repro_torch.fault.resilience' not in sys.modules\n"
            "assert 'repro_torch.arch' not in sys.modules\n"
            "from repro_torch.sim import PacketSim\n"
            "assert core.PacketSim is PacketSim\n"
            "from repro_torch.arch import codesign\n"
            "assert core.codesign is codesign\n"
            "for n in ('simulate_events', 'policy_sweep', 'policy_sweep_all',"
            " 'PolicySweepResult', 'fidelity_report'):\n"
            "    getattr(core, n)\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
