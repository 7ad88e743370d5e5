"""`python -m odh_kubeflow_tpu_torch.analysis`, the port's lint lane, run in
a subprocess that refuses every import of jax, PyYAML and the JAX package
(the card's machine has neither jax nor PyYAML): each mode of the
reference's CLI and its exit code (0 clean, 1 findings, 2 usage error).

The full pass over the installed package and the selected-check pass, the
audit of what the pragmas hide, the checker list, the live-registry and
SLO definition lints, the pragma gate against the port's allowlist (and a
short allowlist, and a missing one), the allowlist's update (which rebuilds
the committed file byte for byte, and refuses paths), a deploy-surface
artifact, the machine specs' Markdown, the interleaving explorer, a seeded
bad file, an unknown check and an unknown flag.

`--machines-doc` equals the JAX package's render but for two descriptions of
the inference machine, which name the reference's issue: `DOC_DIFFERENCES`.

Without PyYAML, crd-schema-drift reads the committed tree with the port's
own reader of the form `render_yaml` writes (`deploy.overlay.load_yaml`),
held here to PyYAML on every committed file and on every overlay's render.
"""
import os
import pathlib
import subprocess
import sys

import pytest

import odh_kubeflow_tpu_torch
from odh_kubeflow_tpu_torch.analysis.checkers import make_checkers

REPO = pathlib.Path(odh_kubeflow_tpu_torch.__file__).resolve().parent.parent
ALLOWLIST = REPO / "odh_kubeflow_tpu_torch" / "analysis" / "pragma_allowlist.txt"
REFUSED = ("jax", "jaxlib", "yaml", "odh_kubeflow_tpu")
PRELUDE = (
    "import runpy, sys\n"
    f"for name in {REFUSED!r}:\n"
    "    sys.modules[name] = None\n"
    "sys.argv = ['odh_kubeflow_tpu_torch.analysis'] + sys.argv[1:]\n"
    "runpy.run_module('odh_kubeflow_tpu_torch.analysis', run_name='__main__', alter_sys=True)\n"
)
# the port's text of the two lines where its render differs from the
# reference's, whose two descriptions of the inference machine cite the
# reference's issue tracker
DOC_DIFFERENCES = ("The machine has a scale-to-zero edge", "| scale-to-zero park: replicas 0")


def lint(*args, cwd=None, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("INVCHECK", None)
    proc = subprocess.run([sys.executable, "-c", PRELUDE, *map(str, args)], cwd=cwd or REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


@pytest.mark.parametrize("name", ["base", "overlays/dev", "overlays/gke", "overlays/standalone"])
def test_the_ports_yaml_reader_reads_the_committed_tree_as_pyyaml_does(name):
    import yaml

    from odh_kubeflow_tpu_torch.deploy.overlay import build, load_yaml, render_yaml

    text = (REPO / "odh_kubeflow_tpu_torch" / "deploy" / "tree" / name / "manifests.yaml").read_text()
    assert load_yaml(text) == [doc for doc in yaml.safe_load_all(text) if doc is not None]
    manifests = build(name.rpartition("/")[2])
    assert load_yaml(render_yaml(manifests)) == manifests


def test_the_ports_yaml_reader_refuses_another_form():
    from odh_kubeflow_tpu_torch.deploy.overlay import load_yaml

    with pytest.raises(ValueError):
        load_yaml("a: 1\n  b: 2\n")


def test_the_prelude_refuses_jax_yaml_and_the_reference(tmp_path):
    for name in REFUSED:
        probe = tmp_path / "probe.py"
        probe.write_text(f"import {name}\n")
        code = PRELUDE.replace("runpy.run_module('odh_kubeflow_tpu_torch.analysis', run_name='__main__', "
                               "alter_sys=True)", f"runpy.run_path({str(probe)!r})")
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
        assert proc.returncode == 1 and f"import of {name} halted" in proc.stderr


def test_the_full_pass_is_clean_from_any_directory(tmp_path):
    rc, out, err = lint(cwd=tmp_path)
    assert rc == 0, out + err
    assert out.strip().splitlines()[-1] == "analysis OK: no findings"


def test_the_torchlint_pair_alone_is_clean():
    rc, out, err = lint("--check", "host-transfer", "--check", "psum-axis")
    assert (rc, out.strip()) == (0, "analysis OK: no findings"), err


def test_include_suppressed_shows_what_the_pragmas_hide():
    rc, out, _ = lint("--include-suppressed")
    assert rc == 1
    lines = out.strip().splitlines()
    assert lines[-1] == "15 finding(s)"
    assert sum("[host-transfer]" in line for line in lines) == 2
    assert sum("probe/behavior.py" in line and "[lock-discipline]" in line for line in lines) == 2


def test_list_checks_names_every_checker_but_jaxlints_other_two():
    rc, out, _ = lint("--list-checks")
    assert rc == 0
    assert out.split() == [c.name for c in make_checkers()] == [
        "cache-mutation", "lock-discipline", "lock-order", "swallowed-exception", "metric-convention",
        "annotation-convention", "machine-conformance", "host-transfer", "psum-axis", "rbac-coverage",
        "crd-schema-drift", "env-contract", "flow-schema-coverage"]


@pytest.mark.parametrize("mode,said", [("--registry-lint", "metrics lint OK: "), ("--slo-lint", "slo lint OK: ")])
def test_the_live_registry_lints_pass(mode, said):
    rc, out, err = lint(mode)
    assert rc == 0, out + err
    assert out.startswith(said)


def test_the_pragma_gate_passes_the_port_allowlist(tmp_path):
    rc, out, err = lint("--pragma-gate", ALLOWLIST, cwd=tmp_path)
    assert rc == 0, out + err
    assert out.startswith("pragma gate OK: 12 pragma(s) across 6 (path, check) entries, all reviewed")
    assert "stale" not in out


def test_the_pragma_gate_fails_an_unreviewed_pragma_and_a_missing_allowlist(tmp_path):
    short = tmp_path / "short.txt"
    short.write_text("".join(line for line in ALLOWLIST.read_text().splitlines(keepends=True)
                             if "probe/behavior.py" not in line))
    rc, out, _ = lint("--pragma-gate", short)
    assert rc == 1
    assert "odh_kubeflow_tpu_torch/probe/behavior.py: 2 `# lint: disable=lock-discipline`" in out
    rc, _, err = lint("--pragma-gate", tmp_path / "missing.txt")
    assert rc == 1 and "missing" in err


def test_the_pragma_update_rebuilds_the_committed_allowlist(tmp_path):
    rebuilt = tmp_path / "allowlist.txt"
    rc, out, err = lint("--pragma-update", rebuilt, cwd=tmp_path)
    assert rc == 0, out + err
    assert rebuilt.read_text() == ALLOWLIST.read_text()


def test_the_pragma_update_refuses_paths(tmp_path):
    rc, _, err = lint("--pragma-update", tmp_path / "allowlist.txt", "odh_kubeflow_tpu_torch/serving")
    assert rc == 2 and "WHOLE tree" in err
    assert not (tmp_path / "allowlist.txt").exists()


def test_a_deploy_surface_artifact_is_read(tmp_path):
    artifact = tmp_path / "surface.json"
    artifact.write_text('{"surface": []}')
    rc, out, err = lint("--check", "rbac-coverage", "--deploy-surface", artifact)
    assert (rc, out.strip()) == (0, "analysis OK: no findings"), err


def test_the_machines_doc_is_the_reference_render_but_for_two_descriptions():
    from odh_kubeflow_tpu.analysis.machines import render_markdown

    rc, out, _ = lint("--machines-doc")
    assert rc == 0
    theirs, ours = render_markdown().splitlines(), out.removesuffix("\n").splitlines()  # print's newline
    assert len(theirs) == len(ours)
    differ = [line for ref, line in zip(theirs, ours) if ref != line]
    assert len(differ) == len(DOC_DIFFERENCES)
    assert all(text in line for text, line in zip(DOC_DIFFERENCES, differ))


def test_the_explorer_mode_is_clean():
    rc, out, err = lint("--explore", timeout=900)
    assert rc == 0, out + err
    lines = out.strip().splitlines()
    assert lines[0].startswith("explorer[default]: ") and lines[0].endswith("truncated=0, exhausted=True")
    assert lines[1].startswith("explorer[jobs]: ") and lines[1].endswith("truncated=0, exhausted=True")
    assert lines[-1] == "explorer OK: zero invariant violations over the explored spaces"


def test_a_seeded_bad_file_gives_one(tmp_path):
    bad = tmp_path / "controllers" / "bad.py"
    bad.parent.mkdir()
    bad.write_text("def reconcile(req):\n    try:\n        work(req)\n    except:\n        pass\n")
    rc, out, _ = lint(bad)
    assert rc == 1
    assert "bad.py:4: [swallowed-exception] bare `except:`" in out and out.strip().endswith("1 finding(s)")


@pytest.mark.parametrize("args", [("--check", "no-such-check"), ("--no-such-flag",)], ids=["unknown-check", "unknown-flag"])
def test_usage_errors_give_two(args):
    rc, _, err = lint(*args)
    assert rc == 2 and err
