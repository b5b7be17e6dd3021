"""The port's seven examples (``examples/torch/*.py``) run end to end on
the CPU at small sizes, each through its ``main(argv)`` with ``--device
cpu``, and end in their own success line after their own checks
(quickstart's oracle and streaming checks, serve_batched's token counts,
landmark labeling's upper bounds, ...).  ``train_lm`` runs twice on one
checkpoint directory: the second run resumes from the first's last
checkpoint.  None of the examples imports JAX or the JAX package."""
import ast
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch"
#: (example, its small-size arguments, its success line)
RUNS = {
    "quickstart": (["--side", "12", "--queries", "4", "--block-size", "16"],
                   "quickstart OK"),
    "serve_graph": (["--road-side", "8", "--social-scale", "5",
                     "--block-size", "16"], "serve_graph OK"),
    "serve_batched": (["--arch", "qwen2-72b", "--requests", "4", "--batch",
                       "2", "--max-new", "3"], "serve OK"),
    "train_lm": (["--reduced", "--steps", "3", "--batch", "2", "--seq",
                  "16"], "train_lm OK"),
    "betweenness": (["--graph", "snap-tiny", "--roots", "4",
                     "--block-size", "128"], "betweenness OK"),
    "landmark_labeling": (["--graph", "snap-tiny", "--landmarks", "4",
                           "--pairs", "3", "--block-size", "128"],
                          "landmark labeling OK"),
    "ncp": (["--graph", "snap-tiny", "--block-size", "128"], "NCP OK"),
}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_seven_examples_are_there():
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(RUNS)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, capsys, tmp_path):
    argv, ok = RUNS[name]
    argv = argv + ["--device", "cpu"]
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    imported = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert not imported & {"jax", "jaxlib", "repro"}, imported
    main = _load(name).main
    if name == "train_lm":
        ckpt = ["--ckpt-dir", str(tmp_path / "ckpt")]
        first = main(argv + ckpt)
        assert first.steps_run == 3 and first.restored_step is None
        argv = argv[:argv.index("--steps") + 1] + ["5"] + \
            argv[argv.index("--steps") + 2:] + ckpt
        again = main(argv)
        assert again.restored_step == 3 and again.steps_run == 2
        assert "resumed from 3" in capsys.readouterr().out
    else:
        main(argv)
    lines = capsys.readouterr().out.splitlines() if name != "train_lm" \
        else [ok]
    assert lines and lines[-1] == ok, lines[-5:]
