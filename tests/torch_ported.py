"""Runs cases of the JAX package's own test files against the port, and the
same case against the JAX package, in one test.

`load(test_file, side)` reads `tests/<test_file>.py` and executes it as a
module of its own: on the port's side with every import of
`odh_kubeflow_tpu` pointed at `odh_kubeflow_tpu_torch` (plus the file's own
`renames`, for modules the port keeps elsewhere). Its fixtures become plain
functions (`fixture` below stands in for `pytest.fixture` while the source
runs), so `run(module, case, tmp_dir)` can call a case with its fixtures
resolved as pytest would: `tmp_path`, `tmp_path_factory`, `monkeypatch`, the
file's autouse
fixtures first, generator fixtures finished in reverse order.

`wire(side)` records what a case's RemoteStore clients asked of the API
server and what it answered (method, path, status, and the kind, name and
resourceVersion of each object or the reason of each Status), so the two
packages can be held to the same requests and answers; `compare` does so on
the set of exchanges (a watch that reconnects may do so a different number
of times on each side).
"""
import contextlib
import importlib
import inspect
import json
import re
import sys
import tempfile
import types
from pathlib import Path
from urllib.parse import urlsplit

import pytest

TESTS = Path(__file__).resolve().parent


def fixture(*args, **kwargs):
    """`pytest.fixture` while a loaded test file runs: marks the function
    (with `autouse`) and returns it unchanged."""
    def mark(fn):
        fn._ported_fixture = True
        fn._ported_autouse = bool(kwargs.get("autouse"))
        return fn

    if args and callable(args[0]):
        return mark(args[0])
    return mark


_FIXTURE = re.compile(r"^@pytest\.fixture\b", re.M)
_PACKAGE = re.compile(r"\bodh_kubeflow_tpu\b(?!_torch)")


def load(test_file, side, renames=(), edits=()):
    """The JAX test file `test_file` as a module for `side` ("jax" or
    "port"); `renames` are (old, new) text replacements applied after the
    package rename on the port's side, `edits` ones applied on both."""
    src = (TESTS / f"{test_file}.py").read_text()
    src = _FIXTURE.sub("@_ported_fixture", src)
    for old, new in edits:
        assert old in src, f"{test_file}: {old!r} not found"
        src = src.replace(old, new)
    if side == "port":
        src = _PACKAGE.sub("odh_kubeflow_tpu_torch", src)
        for old, new in renames:
            assert old in src, f"{test_file}: {old!r} not found"
            src = src.replace(old, new)
    name = f"_ported_{side}_{test_file}"
    module = types.ModuleType(name)
    module.__file__ = str(TESTS / f"{test_file}.py")
    module._ported_fixture = fixture
    sys.modules[name] = module
    exec(compile(src, module.__file__, "exec"), module.__dict__)
    return module


def cases(module, skip=()):
    """The module's test functions, by name, in file order, less `skip`."""
    found = [(fn.__code__.co_firstlineno, name) for name, fn in vars(module).items()
             if name.startswith("test_") and inspect.isfunction(fn) and name not in skip]
    return [name for _, name in sorted(found)]


def run(module, case, tmp_dir):
    """Calls `module.case` with its fixtures resolved; returns its result."""
    fixtures = {name: fn for name, fn in vars(module).items() if getattr(fn, "_ported_fixture", False)}
    with contextlib.ExitStack() as stack:
        values = {}

        def resolve(arg):
            if arg in values:
                return values[arg]
            if arg == "tmp_path":
                value = Path(tempfile.mkdtemp(dir=tmp_dir))
            elif arg == "tmp_path_factory":
                value = types.SimpleNamespace(
                    mktemp=lambda name, numbered=True: Path(tempfile.mkdtemp(prefix=name, dir=tmp_dir)))
            elif arg == "monkeypatch":
                value = pytest.MonkeyPatch()
                stack.callback(value.undo)
            elif arg in fixtures:
                fn = fixtures[arg]
                out = fn(**{a: resolve(a) for a in inspect.signature(fn).parameters})
                if inspect.isgenerator(out):
                    value = next(out)
                    stack.callback(_finish, out)
                else:
                    value = out
            else:
                raise LookupError(f"{case}: no fixture {arg!r}")
            values[arg] = value
            return value

        for name, fn in fixtures.items():
            if fn._ported_autouse:
                resolve(name)
        fn = getattr(module, case)
        return fn(**{a: resolve(a) for a in inspect.signature(fn).parameters})


def _finish(gen):
    try:
        next(gen)
    except StopIteration:
        pass


def _summary(data):
    """What a reply body said, without what differs between two stores
    (uids, timestamps): the kind and name and resourceVersion of an object,
    the names of a list's items, the reason and code of a Status."""
    try:
        body = json.loads(data) if data else None
    except ValueError:
        return "non-json"
    if not isinstance(body, dict):
        return type(body).__name__
    if body.get("kind") == "Status":
        return ("Status", body.get("reason"), body.get("code"))
    meta = body.get("metadata") or {}
    if "items" in body:
        return (body.get("kind"), tuple(sorted((i.get("metadata") or {}).get("name", "") for i in body["items"])))
    return (body.get("kind"), meta.get("name"), meta.get("resourceVersion"))


@contextlib.contextmanager
def wire(side):
    """Records every exchange of the side's RemoteStore clients: pooled
    requests (HostPool) and watch streams (RemoteStore._open). Yields the
    list the exchanges go into."""
    remote = importlib.import_module(
        "odh_kubeflow_tpu.cluster.remote" if side == "jax" else "odh_kubeflow_tpu_torch.cluster.remote")
    seen = []
    pool_request, store_open = remote.HostPool.request, remote.RemoteStore._open

    def request(self, method, path, body, headers):
        status, data = pool_request(self, method, path, body, headers)
        seen.append((method, _path(path), status, _summary(data)))
        return status, data

    def open_(self, path, method="GET", body=None, content_type=None, timeout=None):
        try:
            resp = store_open(self, path, method=method, body=body, content_type=content_type, timeout=timeout)
        except Exception as e:
            seen.append((method, _path(path), type(e).__name__, None))
            raise
        seen.append((method, _path(path), resp.status, None))
        return resp

    remote.HostPool.request, remote.RemoteStore._open = request, open_
    try:
        yield seen
    finally:
        remote.HostPool.request, remote.RemoteStore._open = pool_request, store_open


def _path(path):
    """A request's path and its query keys (a watch's resume point and
    timeout vary with timing)."""
    parts = urlsplit(path)
    keys = sorted(k.split("=")[0] for k in parts.query.split("&") if k)
    return parts.path + ("?" + "&".join(keys) if keys else "")


def _timed(exchange):
    """A watch stream answered 410 Gone: whether writes outran the
    stream's first connection past the store's history window depends on
    timing (the reflector then relists, which both sides record)."""
    method, path, status, _ = exchange
    return status == "GoneError" and "watch" in path.partition("?")[2].split("&")


def compare(jax_seen, port_seen, case):
    """The two sides asked the same things and were answered the same
    (`_timed` exchanges aside)."""
    jax_set = {e for e in jax_seen if not _timed(e)}
    port_set = {e for e in port_seen if not _timed(e)}
    assert port_set == jax_set, (
        f"{case}: only the JAX side saw {sorted(jax_set - port_set, key=repr)}; "
        f"only the port saw {sorted(port_set - jax_set, key=repr)}")


def both(jax_module, port_module, case, tmp_dir, transcript=True):
    """Runs `case` on the JAX side, then on the port's, each under `wire`;
    with `transcript`, compares the two sides' exchanges. Returns them."""
    with wire("jax") as jax_seen:
        run(jax_module, case, tmp_dir)
    with wire("port") as port_seen:
        run(port_module, case, tmp_dir)
    if transcript:
        compare(jax_seen, port_seen, case)
    return jax_seen, port_seen
