"""The port covers the reference, file for file and name for name.

The mover-jax wire schema (``volsync_tpu_torch/service/moverjax.proto``)
is the reference's byte for byte, and the port's committed
``moverjax_pb2.py`` is what it compiles to: checked by a small parser
here, and by ``protoc`` where one is installed. Every file of
``volsync_tpu/`` has a port counterpart at the same relative path, and
every public top-level function and class of a reference module, with
every public method of such a class, exists under the same name in the
port's module, save the names in ``RENAMED`` and ``BY_DESIGN``. Those
two lists are held exact: each entry names a reference symbol that the
port's module truly lacks. The reference is read as bytes and ASTs only;
no ``volsync_tpu`` module is imported. Names found only in the port are
not checked.
"""

import ast
import re
import shutil
import subprocess
from pathlib import Path

import pytest
from google.protobuf import descriptor_pb2

from volsync_tpu_torch.service import moverjax_pb2

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "volsync_tpu"
PORT = ROOT / "volsync_tpu_torch"
SCHEMA = PORT / "service" / "moverjax.proto"

# Reference name -> the port's name for it, in the module at the same
# relative path ("module path:Class.method").
RENAMED = {
    "ops/rs.py:gf_matmul_device": "gf_matmul",
    "cluster/sessions.py:JaxSessionBackend": "TorchSessionBackend",
    "cluster/sessions.py:JaxSessionBackend.acquire":
        "TorchSessionBackend.acquire",
    "cluster/sessions.py:JaxSessionBackend.keepalive":
        "TorchSessionBackend.keepalive",
    "cluster/sessions.py:JaxSessionBackend.probe":
        "TorchSessionBackend.probe",
    "cluster/sessions.py:JaxSessionBackend.release":
        "TorchSessionBackend.release",
    "cluster/sessions.py:JaxSessionBackend.force_release":
        "TorchSessionBackend.force_release",
}

# Reference names the port has no counterpart for, each with its reason.
BY_DESIGN = {
    "ops/sha256.py:use_pallas_leaves":
        "no Pallas/XLA choice: a CUDA tensor always runs the kernel",
    "envflags.py:no_pallas":
        "VOLSYNC_NO_PALLAS picks between Pallas and XLA, which torch has not",
    "envflags.py:donate_device_inputs":
        "VOLSYNC_DONATE: torch donates no buffer to a dispatch",
    "envflags.py:root_unroll":
        "VOLSYNC_ROOT_UNROLL unrolls a traced XLA loop; merkle_roots is a "
        "CUDA kernel",
    "analysis/shapes.py:PyAt":
        "the lint's model of JAX's .at[] updates, which torch has not",
    "analysis/shapes.py:PyAtIndexed":
        "the lint's model of JAX's .at[i] updates, which torch has not",
    "analysis/shapes.py:PyWrapped":
        "the lint's model of shard_map/jit wrappers, which torch has not",
    "obs/tracing.py:stage_seconds_by_tenant":
        "volsync_svc_stage_seconds in metrics.GLOBAL holds the same "
        "seconds; the port keeps no second copy",
}


def _ref_files():
    return sorted(p.relative_to(REF) for p in REF.rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts
                  and p.suffix != ".pyc")


def _group(rel: Path) -> str:
    return rel.parts[0] if len(rel.parts) > 1 else "root"


GROUPS = sorted({_group(rel) for rel in _ref_files()})


def _public_names(path: Path) -> set:
    """Public top-level functions and classes, and the public methods of
    public classes ("Class.method")."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out |= {f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not m.name.startswith("_")}
    return out


def _bound(body) -> set:
    """Names a module or class body binds: defs, classes, assignments
    and imports."""
    out = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _port_names(path: Path) -> set:
    """Every name the port module binds at top level, and every name a
    top-level class of it binds ("Class.name")."""
    if not path.is_file():
        return set()
    body = ast.parse(path.read_text()).body
    out = _bound(body)
    for node in body:
        if isinstance(node, ast.ClassDef):
            out |= {f"{node.name}.{n}" for n in _bound(node.body)}
    return out


# -- the wire schema -----------------------------------------------------

def test_schema_is_the_references():
    assert SCHEMA.read_bytes() == (REF / "service" / "moverjax.proto"
                                   ).read_bytes()


_SCALARS = {
    "bytes": descriptor_pb2.FieldDescriptorProto.TYPE_BYTES,
    "bool": descriptor_pb2.FieldDescriptorProto.TYPE_BOOL,
    "string": descriptor_pb2.FieldDescriptorProto.TYPE_STRING,
    "uint64": descriptor_pb2.FieldDescriptorProto.TYPE_UINT64,
}


def _parse_schema(text: str) -> dict:
    """The subset of proto3 the schema uses: package, flat messages of
    scalar or message fields, and any service blocks (counted)."""
    text = re.sub(r"//[^\n]*", "", text)
    assert re.search(r'syntax\s*=\s*"proto3"\s*;', text)
    messages = {}
    for name, body in re.findall(r"\bmessage\s+(\w+)\s*\{([^{}]*)\}", text):
        fields = re.findall(r"(repeated\s+)?(\w+)\s+(\w+)\s*=\s*(\d+)\s*;",
                            body)
        assert len(fields) == body.count(";"), (name, body)
        messages[name] = [(fname, int(num), bool(rep), ftype)
                          for rep, ftype, fname, num in fields]
    return {"package": re.search(r"\bpackage\s+([\w.]+)\s*;", text)[1],
            "messages": messages,
            "services": re.findall(r"\bservice\s+(\w+)", text)}


def test_schema_matches_the_generated_module():
    schema = _parse_schema(SCHEMA.read_text())
    desc = moverjax_pb2.DESCRIPTOR
    assert desc.name == "moverjax.proto"
    assert schema["package"] == desc.package == "moverjax"
    assert schema["services"] == [] and len(desc.services_by_name) == 0
    assert list(schema["messages"]) == list(desc.message_types_by_name)
    assert len(schema["messages"]) == 8
    for name, fields in schema["messages"].items():
        got = []
        for f in desc.message_types_by_name[name].fields:
            if f.message_type is not None:
                ftype = f.message_type.full_name.removeprefix("moverjax.")
            else:
                ftype = next(k for k, v in _SCALARS.items() if v == f.type)
            got.append((f.name, f.number, f.is_repeated, ftype))
        assert got == fields, name


@pytest.mark.skipif(shutil.which("protoc") is None,
                    reason="no protoc on PATH")
def test_protoc_compiles_the_schema_to_the_generated_descriptor(tmp_path):
    out = tmp_path / "moverjax.pb"
    r = subprocess.run(["protoc", f"--proto_path={SCHEMA.parent}",
                        f"--descriptor_set_out={out}", SCHEMA.name],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    got = descriptor_pb2.FileDescriptorSet.FromString(out.read_bytes())
    assert len(got.file) == 1
    compiled = got.file[0]
    # protoc's descriptor set fills json_name; the Python generator
    # leaves it out of the serialized file.
    for message in compiled.message_type:
        for field in message.field:
            field.ClearField("json_name")
    want = descriptor_pb2.FileDescriptorProto.FromString(
        moverjax_pb2.DESCRIPTOR.serialized_pb)
    assert compiled == want


# -- the parity guard ----------------------------------------------------

@pytest.mark.parametrize("group", GROUPS)
def test_every_reference_file_has_a_port_counterpart(group):
    rels = [rel for rel in _ref_files() if _group(rel) == group]
    assert rels
    assert [str(rel) for rel in rels if not (PORT / rel).is_file()] == []


@pytest.mark.parametrize("group", GROUPS)
def test_every_public_reference_name_has_a_port_counterpart(group):
    missing = []
    for rel in _ref_files():
        if _group(rel) != group or rel.suffix != ".py":
            continue
        port = _port_names(PORT / rel)
        for name in sorted(_public_names(REF / rel)):
            key = f"{rel.as_posix()}:{name}"
            if key in BY_DESIGN:
                continue
            if RENAMED.get(key, name) not in port:
                missing.append((key, RENAMED.get(key)))
    assert missing == []


def test_parity_exceptions_are_exact():
    assert not set(RENAMED) & set(BY_DESIGN)
    for key in [*RENAMED, *BY_DESIGN]:
        rel, name = key.split(":")
        assert name in _public_names(REF / rel), key
        assert name not in _port_names(PORT / rel), key
    for key, port_name in RENAMED.items():
        assert port_name in _port_names(PORT / key.split(":")[0]), key
    assert all(reason.strip() for reason in BY_DESIGN.values())
