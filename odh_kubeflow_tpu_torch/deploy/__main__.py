"""CLI: render the port's deployment manifests.

  python -m odh_kubeflow_tpu_torch.deploy build [overlay] [--params PATH]
  python -m odh_kubeflow_tpu_torch.deploy crd
  python -m odh_kubeflow_tpu_torch.deploy generate [--root DIR]

`generate` writes the committed YAML under the package's `tree/` (the analog
of running kustomize build + controller-gen in the reference's
ci/generate_code.sh and ci/kustomize.sh): `base/manifests.yaml`,
`overlays/<name>/manifests.yaml`, and `params.env` when the root has none
(the images and namespace every overlay starts from). The crd-schema-drift
checker holds the committed CRDs to the generator.
"""
from __future__ import annotations

import argparse
import os
import sys

from .overlay import DEFAULT_PARAMS, OVERLAYS, build, load_params, render_yaml

TREE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tree")

_PARAMS_HEADER = (
    "# Image pinning, the reference's config/base/params.env mechanism\n"
    "# (odh config/base/kustomization.yaml:5-41 replacements).\n"
)


def _read_params(path: str | None):
    if not path:
        return None
    with open(path) as f:
        return load_params(f.read())


def generate_tree(root: str, params_path: str | None = None) -> list:
    params = _read_params(params_path)
    written = []
    for name in sorted(OVERLAYS):
        out_dir = os.path.join(root, "base" if name == "base" else f"overlays/{name}")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "manifests.yaml")
        with open(path, "w") as f:
            f.write(render_yaml(build(name, params)))
        written.append(path)
    params_env = os.path.join(root, "params.env")
    if not os.path.exists(params_env):
        with open(params_env, "w") as f:
            f.write(_PARAMS_HEADER)
            for k, v in {**DEFAULT_PARAMS, **(params or {})}.items():
                f.write(f"{k}={v}\n")
        written.append(params_env)
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="odh_kubeflow_tpu_torch.deploy")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build")
    b.add_argument("overlay", nargs="?", default="base")
    b.add_argument("--params", default=None)
    sub.add_parser("crd")
    g = sub.add_parser("generate")
    g.add_argument("--root", default=TREE)
    g.add_argument("--params", default=None)
    args = ap.parse_args(argv)

    if args.cmd == "build":
        sys.stdout.write(render_yaml(build(args.overlay, _read_params(args.params))))
    elif args.cmd == "crd":
        from .crdgen import notebook_crd

        sys.stdout.write(render_yaml([notebook_crd()]))
    elif args.cmd == "generate":
        params = os.path.join(args.root, "params.env")
        for p in generate_tree(
            args.root, params if os.path.exists(params) else args.params
        ):
            print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
