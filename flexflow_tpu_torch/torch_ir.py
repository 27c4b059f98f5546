"""Serialized op-list interop — FlexFlow's torch_to_file/file_to_ff format
(port of ``flexflow_tpu/torch_ir.py``, the same field orders).

FlexFlow's torch frontend has two paths: a live fx walk and a serialized
one — ``PyTorchModel.torch_to_file`` writes one line per graph node
(``name; innodes,; outnodes,; OP_TYPE; <op fields>``, with per-node
``parse``/``string_to_ff`` pairs) and ``file_to_ff`` replays the file onto
an FFModel. This module implements the same file format against the port's
FFModel so:

- model files produced by the reference load here (``file_to_ff``);
- our fx frontend can export reference-consumable files (``torch_to_file``);
- graphs round-trip (export -> import -> numerically identical model).

Enum encodings match the reference's ``flexflow/type.py``:
ActiMode AC_MODE_NONE=10/RELU=11/SIGMOID=12/TANH=13/GELU=14;
PoolType POOL_MAX=30/POOL_AVG=31; op-type field is the OpType NAME.
Field orders follow each reference node's ``parse()``.

Covered op set: INPUT, OUTPUT, LINEAR, CONV2D, POOL2D, FLAT, RELU, SIGMOID,
TANH, GELU, ELU, IDENTITY, BATCH_NORM, LAYER_NORM, DROPOUT, SOFTMAX, ADD,
SUBTRACT, MULTIPLY, CONCAT, EMBEDDING — the set the reference's serialized
examples (CNNs/MLPs/AlexNet-style) exercise. Unknown op types raise.
"""

from __future__ import annotations

from typing import List, Sequence

IR_DELIMITER = "; "
INOUT_NODE_DELIMITER = ","

_ACTI_TO_INT = {None: 10, "relu": 11, "sigmoid": 12, "tanh": 13, "gelu": 14}
_INT_TO_ACTI = {v: k for k, v in _ACTI_TO_INT.items()}
_POOL_TO_INT = {"max": 30, "avg": 31}
_INT_TO_POOL = {v: k for k, v in _POOL_TO_INT.items()}

_UNARY_OPS = {
    "RELU": "relu", "SIGMOID": "sigmoid", "TANH": "tanh", "GELU": "gelu",
    "ELU": "elu", "IDENTITY": "identity",
}
_BINARY_OPS = {"ADD": "add", "SUBTRACT": "subtract", "MULTIPLY": "multiply"}


def _inout(names: Sequence[str]) -> str:
    return (INOUT_NODE_DELIMITER.join(names) + INOUT_NODE_DELIMITER
            if names else "")


# ---------------------------------------------------------------------------
# import: reference-format lines -> ops on an FFModel
# ---------------------------------------------------------------------------


def string_to_ff(lines: Sequence[str], ffmodel, input_tensors):
    """Replay serialized node lines onto ``ffmodel`` (reference
    ``PyTorchModel.file_to_ff``); returns the output tensors."""
    node_out = {}
    outputs: List = []
    input_index = 0
    for raw in lines:
        line = raw.strip()
        if not line:
            continue
        items = [i.strip() for i in line.split(";")]
        name = items[0]
        ins = [n.strip() for n in items[1].split(INOUT_NODE_DELIMITER)
               if n.strip()]
        op = items[3]
        if op == "INPUT":
            node_out[name] = input_tensors[input_index]
            input_index += 1
            continue
        if op == "OUTPUT":
            outputs.extend(node_out[i] for i in ins)
            continue
        known = ({"LINEAR", "CONV2D", "POOL2D", "FLAT", "BATCH_NORM",
                  "LAYER_NORM", "DROPOUT", "SOFTMAX", "CONCAT", "EMBEDDING"}
                 | set(_UNARY_OPS) | set(_BINARY_OPS))
        if op not in known:
            raise NotImplementedError(
                f"serialized op type {op!r} (node {name!r}) is not in the "
                f"supported interop set")
        x = [node_out[i] for i in ins]
        if op == "LINEAR":
            out = ffmodel.dense(
                x[0], int(items[4]),
                activation=_INT_TO_ACTI[int(items[5])],
                use_bias=bool(int(items[6])), name=name)
        elif op == "CONV2D":
            out = ffmodel.conv2d(
                x[0], int(items[4]), int(items[5]), int(items[6]),
                int(items[7]), int(items[8]), int(items[9]), int(items[10]),
                activation=_INT_TO_ACTI[int(items[11])],
                groups=int(items[12]), use_bias=bool(int(items[13])),
                name=name)
        elif op == "POOL2D":
            k, s, p = int(items[4]), int(items[5]), int(items[6])
            out = ffmodel.pool2d(
                x[0], k, k, s, s, p, p,
                pool_type=_INT_TO_POOL[int(items[7])], name=name)
            act = _INT_TO_ACTI[int(items[8])]
            if act is not None:
                out = getattr(ffmodel, act)(out)
        elif op == "FLAT":
            out = ffmodel.flat(x[0], name=name)
        elif op in _UNARY_OPS:
            out = getattr(ffmodel, _UNARY_OPS[op])(x[0])
        elif op in _BINARY_OPS:
            out = getattr(ffmodel, _BINARY_OPS[op])(x[0], x[1])
        elif op == "BATCH_NORM":
            out = ffmodel.batch_norm(x[0], relu=False, name=name)
        elif op == "LAYER_NORM":
            out = ffmodel.layer_norm(x[0], name=name)
        elif op == "DROPOUT":
            out = ffmodel.dropout(x[0], rate=float(items[4]), name=name)
        elif op == "SOFTMAX":
            # our exports carry the axis as an extra field; reference files
            # have none (their softmax is always last-axis)
            axis = int(items[4]) if len(items) > 4 else -1
            out = ffmodel.softmax(x[0], axis=axis)
        elif op == "CONCAT":
            out = ffmodel.concat(x, int(items[4]), name=name)
        elif op == "EMBEDDING":
            out = ffmodel.embedding(x[0], int(items[4]), int(items[5]),
                                    name=name)
        else:
            raise NotImplementedError(
                f"serialized op type {op!r} (node {name!r}) is not in the "
                f"supported interop set")
        node_out[name] = out
    return outputs


def file_to_ff(filename: str, ffmodel, input_tensors):
    """Load a reference-format serialized model file onto ``ffmodel``."""
    with open(filename) as f:
        return string_to_ff(f.readlines(), ffmodel, input_tensors)


# ---------------------------------------------------------------------------
# export: FFModel graph -> reference-format lines
# ---------------------------------------------------------------------------

_EXPORT_UNARY = {v: k for k, v in _UNARY_OPS.items()}
_EXPORT_BINARY = {"add": "ADD", "sub": "SUBTRACT", "mul": "MULTIPLY"}


def model_to_string(ffmodel) -> List[str]:
    """Serialize an FFModel graph to reference-format lines (the
    ``torch_to_string`` analog, one line per node in topo order)."""
    nodes = ffmodel._nodes
    consumers = {i: [] for i in range(len(nodes))}
    for j, n in enumerate(nodes):
        for t in n.inputs:
            consumers[t.node].append(nodes[j].name)
    lines = []
    for j, n in enumerate(nodes):
        name = n.name
        ins = _inout([nodes[t.node].name for t in n.inputs])
        outs = _inout(consumers[j])
        a = n.attrs
        if n.op == "input":
            s = [name, ins, outs, "INPUT"]
        elif n.op == "dense":
            s = [name, ins, outs, "LINEAR", str(a["out_dim"]),
                 str(_ACTI_TO_INT[a.get("activation")]),
                 "1" if a.get("use_bias", True) else "0"]
        elif n.op == "conv2d":
            kh, kw = a["kernel"]
            sh, sw = a["stride"]
            ph, pw = a["padding"]
            s = [name, ins, outs, "CONV2D", str(a["out_channels"]),
                 str(kh), str(kw), str(sh), str(sw), str(ph), str(pw),
                 str(_ACTI_TO_INT[a.get("activation")]),
                 str(a.get("groups", 1)),
                 "1" if a.get("use_bias", True) else "0"]
        elif n.op == "pool2d":
            s = [name, ins, outs, "POOL2D", str(a["kernel"][0]),
                 str(a["stride"][0]), str(a["padding"][0]),
                 str(_POOL_TO_INT[a.get("pool_type", "max")]), "10"]
        elif n.op == "flat":
            s = [name, ins, outs, "FLAT"]
        elif n.op in _EXPORT_UNARY:
            s = [name, ins, outs, _EXPORT_UNARY[n.op]]
        elif n.op in _EXPORT_BINARY:
            s = [name, ins, outs, _EXPORT_BINARY[n.op]]
        elif n.op == "batch_norm":
            s = [name, ins, outs, "BATCH_NORM"]
        elif n.op == "layer_norm":
            s = [name, ins, outs, "LAYER_NORM"]
        elif n.op == "dropout":
            s = [name, ins, outs, "DROPOUT", str(a.get("rate", 0.5))]
        elif n.op == "softmax":
            # extra axis field (reference readers ignore trailing fields;
            # ours round-trips non-default axes — review r5)
            s = [name, ins, outs, "SOFTMAX", str(a.get("axis", -1))]
        elif n.op == "concat":
            s = [name, ins, outs, "CONCAT", str(a["axis"])]
        elif n.op == "embedding":
            s = [name, ins, outs, "EMBEDDING", str(a["num_entries"]),
                 str(a["out_dim"])]
        else:
            raise NotImplementedError(
                f"op {n.op!r} (node {name!r}) has no serialized form in the "
                f"reference format")
        lines.append(IR_DELIMITER.join(s))
    # synthetic OUTPUT node for the root (reference graphs end with output)
    root = nodes[-1].name
    lines.append(IR_DELIMITER.join(
        ["output", _inout([root]), "", "OUTPUT"]))
    return lines


def model_to_file(ffmodel, filename: str) -> None:
    with open(filename, "w") as f:
        for line in model_to_string(ffmodel):
            f.write(line + "\n")


def torch_to_file(module, example_shape, filename: str) -> None:
    """fx-trace a torch module (via the port's torch frontend) and export it
    in the reference's serialized format (``PyTorchModel.torch_to_file``
    analog). Only the graph is written, so it is built on the CPU: no
    tensor is made."""
    from flexflow_tpu_torch.torch_frontend import from_torch_module

    ff = from_torch_module(module, [tuple(example_shape)],
                           transfer_weights=False, device="cpu")
    model_to_file(ff, filename)
