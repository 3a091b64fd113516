"""Nothing the harness loads is JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys

from helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "flow_timesnet_tpu", "bench", "tools"}


def test_no_source_imports_them():
    for path in (ROOT / "portbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_nothing_loaded_is_jax():
    code = (
        "import sys; sys.argv = ['x']\n"
        "sys.path.insert(0, 'portbench')\n"
        "import run\n"
        "from portbench import controls\n"
        "from portbench.harness import manifest, train, serve, program, trace, data, flops\n"
        "from portbench.reference import timesnet, inputs\n"
        "from portbench.reference import train as rtrain\n"
        "bench = manifest.load()\n"
        "[manifest.reader(m['name']) for m in bench['end_to_end'] + bench['per_layer']]\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert "flow_timesnet_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "flow_timesnet_tpu"}
    assert "chip_smoke" not in loaded
