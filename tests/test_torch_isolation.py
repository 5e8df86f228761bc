"""The port stands alone: importing every module of
modelcompression_tpu_torch loads neither JAX nor the JAX package, its
entry points refuse to run on a machine without CUDA unless the CPU was
asked for, and chip_smoke.py fails (printing no result) without CUDA or
without the port's package beside it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "modelcompression_tpu_torch"
OK_LINE = '"ok": true'


def _env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a GPU machine
    env["PYTHONPATH"] = str(REPO)
    return env


def _run(code, cwd=REPO):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)


_IMPORT_ALL = """
import importlib, pkgutil, sys
import modelcompression_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m.startswith('jaxlib')
             or m == 'modelcompression_tpu'
             or m.startswith('modelcompression_tpu.'))
print(len(names), 'modules')
print('BAD', bad)
"""


def test_importing_the_port_loads_no_jax():
    r = _run(_IMPORT_ALL)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    n = int(r.stdout.split()[0])
    assert n >= 20


def test_no_source_file_imports_jax_or_the_jax_package():
    """Static check over every .py of the port (lazy imports inside
    functions included). Note the prefix trap: modelcompression_tpu_torch
    starts with modelcompression_tpu, so match module names exactly."""
    offenders = []
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib") or top == "modelcompression_tpu":
                    offenders.append(f"{path.relative_to(REPO)}: {m}")
    assert offenders == []


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in mods if m.split(".")[0] in
                ("jax", "jaxlib", "modelcompression_tpu")]


def test_make_eval_step_without_cpu_request_raises():
    r = _run("""
import torch
from modelcompression_tpu_torch.evaluation import EvalConfig, make_eval_step
from modelcompression_tpu_torch.models import tiny_yolov2_voc
assert not torch.cuda.is_available()
spec = tiny_yolov2_voc()
make_eval_step(spec, EvalConfig(device='cpu'))   # explicit CPU: fine
try:
    make_eval_step(spec, EvalConfig())
except RuntimeError as e:
    print('RAISED', e)
""")
    assert r.returncode == 0, r.stderr
    assert "RAISED" in r.stdout and "CUDA" in r.stdout


def test_prune_cli_without_cpu_request_raises():
    """The prune CLI's --device defaults to cuda: without a card it raises
    before reading anything (the weights path need not exist)."""
    r = _run("""
import torch
from modelcompression_tpu_torch.cli import prune
from modelcompression_tpu_torch.models import cfg_path
assert not torch.cuda.is_available()
try:
    prune.main(['--cfg', cfg_path('yolov2-voc.cfg'), '--weights', 'none',
                '--mode', 'magnitude', '--sparsity', '0.5', '--out', 'x'])
except RuntimeError as e:
    print('RAISED', e)
""")
    assert r.returncode == 0, r.stderr
    assert "RAISED" in r.stdout and "CUDA" in r.stdout


def test_finetune_and_train_clis_without_cpu_request_raise():
    """--device defaults to cuda in the finetune and train CLIs: without a
    card each raises before reading anything (the files need not
    exist)."""
    r = _run("""
import torch
from modelcompression_tpu_torch.cli import finetune, train
from modelcompression_tpu_torch.models import cfg_path
assert not torch.cuda.is_available()
cfg = cfg_path('yolov2-voc.cfg')
for main, argv in ((finetune.main, ['--weights', 'none', '--out', 'x']),
                   (train.main, [])):
    try:
        main(['--cfg', cfg, '--data', 'none', '--steps', '1'] + argv)
    except RuntimeError as e:
        print('RAISED', e)
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("RAISED") == 2 and "CUDA" in r.stdout


def test_resolve_device_rule():
    r = _run("""
from modelcompression_tpu_torch.core.device import resolve_device
print(resolve_device('cpu'))
for d in (None, 'cuda'):
    try:
        resolve_device(d)
        print('NO-RAISE', d)
    except RuntimeError:
        print('RAISED', d)
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["cpu", "RAISED", "None", "RAISED", "cuda"]


def test_chip_smoke_fails_without_cuda():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert OK_LINE not in r.stdout
    assert "CUDA" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert OK_LINE not in r.stdout
