"""Checkpoint / resume: bit-exact restart points for long runs.

PyTorch counterpart of `ggs_tpu/utils/checkpoint.py` (save_checkpoint,
save_checkpoint_distributed, load_checkpoint). A state is one
of the port's NamedTuples (GAState, SAState, PTState, GradState); each field
is a tensor, a python int (`gen`, `it`, `step`), the torch.Generator its
steps draw from, or GradState's torch.optim.Adam. All of it goes into one
.npz beside a JSON `__meta__` that names the state type, its fields, each
tensor's shape and dtype, the generator's device type and the Adam
hyperparameters, so a load can refuse a file that does not fit its
template instead of reinterpreting it. The generator is saved as its
get_state() bytes (a CUDA generator's seed and Philox offset, a CPU
generator's Mersenne Twister state) and the Adam moments and step verbatim,
so a resumed run continues the uninterrupted run's trajectory bit for bit.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

FORMAT = "ggs_tpu_torch"
_FORMAT_VERSION = 1
# the Adam param-group entries a checkpoint restores (torch's own
# Optimizer.load_state_dict restores the saved group's values the same way)
_ADAM_HYPER = ("lr", "betas", "eps", "weight_decay", "amsgrad", "maximize")


def _write_npz(path: str, arrays: Dict[str, np.ndarray], payload: Dict[str, Any]) -> None:
    """Atomic write: a temporary file in the target's directory, then
    os.replace; the temporary file is removed on any error."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(payload), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _np_dtype(dtype: torch.dtype) -> str:
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _adam(opt: torch.optim.Optimizer) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if not isinstance(opt, torch.optim.Adam) or len(opt.param_groups) != 1 \
            or len(opt.param_groups[0]["params"]) != 1:
        raise ValueError("a checkpoint holds a torch.optim.Adam over one parameter tensor")
    p = opt.param_groups[0]["params"][0]
    return p, opt.state.get(p, {})


def save_checkpoint(path: str, state: NamedTuple, meta: Dict[str, Any] | None = None) -> None:
    """Save a state NamedTuple and JSON-able metadata atomically."""
    arrays: Dict[str, np.ndarray] = {}
    tensors, ints = {}, {}
    generator = adam = None
    for name, v in zip(state._fields, state):
        if isinstance(v, torch.Tensor):
            arrays[f"t_{name}"] = v.detach().cpu().numpy()
            tensors[name] = {"shape": list(v.shape), "dtype": _np_dtype(v.dtype)}
        elif isinstance(v, torch.Generator):
            arrays["generator"] = v.get_state().numpy()
            generator = {"field": name, "device_type": v.device.type}
        elif isinstance(v, torch.optim.Optimizer):
            _, st = _adam(v)
            group = v.param_groups[0]
            moments = {}
            for k, t in st.items():
                arrays[f"adam_{k}"] = t.detach().cpu().numpy()
                moments[k] = {"shape": list(t.shape), "dtype": _np_dtype(t.dtype)}
            adam = {"field": name, "state": moments,
                    "hyper": {k: group[k] for k in _ADAM_HYPER}}
        elif isinstance(v, int):
            ints[name] = int(v)
        else:
            raise TypeError(f"{type(state).__name__}.{name}: cannot checkpoint {type(v)}")
    payload = {
        "format": FORMAT,
        "format_version": _FORMAT_VERSION,
        "state_type": type(state).__name__,
        "fields": list(state._fields),
        "tensors": tensors,
        "ints": ints,
        "generator": generator,
        "adam": adam,
        "meta": meta or {},
    }
    _write_npz(path, arrays, payload)


def save_checkpoint_distributed(path: str, state: NamedTuple, meta: Dict[str, Any] | None = None,
                                mesh=None) -> None:
    """The save of a run over a mesh (checkpoint.py:56-88): every rank holds
    the same replicated state, so rank 0 writes it (save_checkpoint, atomic)
    and then every rank waits at a barrier, so that no rank goes on (or
    reads the file) before it is written. Resume loads on every rank with
    load_checkpoint. Without a mesh (or outside a process group) it is
    save_checkpoint."""
    import torch.distributed as dist

    if mesh is None or not dist.is_initialized():
        save_checkpoint(path, state, meta)
        return
    if mesh.is_main:
        save_checkpoint(path, state, meta)
    dist.barrier()


def _mismatch(what: str, stored, template) -> ValueError:
    return ValueError(f"checkpoint {what}: stored {stored} does not match template {template} "
                      "(did the config change between save and resume?)")


def load_checkpoint(path: str, like: NamedTuple) -> Tuple[NamedTuple, Dict[str, Any]]:
    """Load a checkpoint into the structure of `like`, a state of the same
    type and shapes (build it from a fresh generator: the saved generator
    state is set on a new generator, after every tensor is placed).

    Returns (state, meta). Tensors, the generator and the Adam moments go to
    the template's devices. Raises ValueError, and never reinterprets, on a
    corrupt or truncated file, a newer format, another state type, a tensor
    whose shape or dtype differs from the template's, a generator saved on
    another device type, or a checkpoint written by the JAX package."""
    try:
        with np.load(path, allow_pickle=False) as z:
            payload = json.loads(str(z["__meta__"]))
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
    except (KeyError, ValueError, OSError, EOFError, zipfile.BadZipFile) as e:
        raise ValueError(f"corrupt or truncated checkpoint {path!r}: {e}") from e
    if "treedef" in payload and "num_leaves" in payload:
        raise ValueError(
            f"{path!r} was written by the JAX package (ggs_tpu.utils.checkpoint); read it with "
            "ggs_tpu_torch.convert.load_jax_checkpoint and ga_state_from_jax (or "
            "sa_state_from_jax / pt_state_from_jax), which start a new random stream")
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path!r} is not a checkpoint of {FORMAT}")
    version = int(payload.get("format_version", 0))
    if version > _FORMAT_VERSION:
        raise ValueError(f"checkpoint {path!r} has format v{version}; this build reads "
                         f"<= v{_FORMAT_VERSION}")
    kind = type(like).__name__
    if payload["state_type"] != kind or payload["fields"] != list(like._fields):
        raise ValueError(f"checkpoint state type mismatch: stored {payload['state_type']}"
                         f"{tuple(payload['fields'])}, template {kind}{like._fields}")

    def tensor(key: str, spec: dict, device) -> torch.Tensor:
        arr = arrays.get(key)
        if arr is None or list(arr.shape) != spec["shape"] or str(arr.dtype) != spec["dtype"]:
            raise ValueError(f"corrupt checkpoint {path!r}: {key} does not match its record")
        return torch.from_numpy(np.array(arr)).to(device)

    out = {}
    for name, tmpl in zip(like._fields, like):
        if isinstance(tmpl, torch.Tensor):
            spec = payload["tensors"].get(name)
            want = {"shape": list(tmpl.shape), "dtype": _np_dtype(tmpl.dtype)}
            if spec != want:
                raise _mismatch(f"tensor {name!r}", spec, want)
            out[name] = tensor(f"t_{name}", spec, tmpl.device)
        elif isinstance(tmpl, int):
            if name not in payload["ints"]:
                raise _mismatch(f"field {name!r}", None, "an int")
            out[name] = int(payload["ints"][name])
    for name, tmpl in zip(like._fields, like):
        if isinstance(tmpl, torch.optim.Optimizer):
            p_tmpl, _ = _adam(tmpl)
            rec = payload["adam"]
            if rec is None or rec["field"] != name:
                raise _mismatch("optimizer", rec, name)
            # the optimizer steps the state's parameter tensor in place: it
            # must be the restored tensor (a GradState's `g`)
            owner = [k for k, t in zip(like._fields, like) if t is p_tmpl]
            if not owner:
                raise TypeError(f"{kind}.{name} does not optimize a field of the state")
            p = out[owner[0]]
            group = dict(tmpl.defaults)
            group.update({k: tuple(v) if k == "betas" else v for k, v in rec["hyper"].items()})
            opt = type(tmpl)([p], **{k: v for k, v in group.items() if k != "params"})
            moments = {}
            for k, spec in rec["state"].items():
                on_param = k != "step" or group.get("capturable") or group.get("fused")
                if k != "step" and spec["shape"] != list(p.shape):
                    raise _mismatch(f"Adam {k}", spec["shape"], list(p.shape))
                moments[k] = tensor(f"adam_{k}", spec, p.device if on_param else "cpu")
            if moments:
                opt.state[p] = moments
            out[name] = opt
    for name, tmpl in zip(like._fields, like):
        if isinstance(tmpl, torch.Generator):
            rec = payload["generator"]
            if rec is None or rec["field"] != name:
                raise _mismatch("generator", rec, name)
            if rec["device_type"] != tmpl.device.type:
                raise ValueError(
                    f"checkpoint generator was saved on {rec['device_type']!r}, the template's "
                    f"is on {tmpl.device.type!r}: its stream cannot continue there")
            gen = torch.Generator(device=tmpl.device)
            try:
                gen.set_state(torch.from_numpy(np.array(arrays["generator"])))
            except (KeyError, RuntimeError) as e:
                raise ValueError(f"corrupt checkpoint {path!r}: generator state: {e}") from e
            out[name] = gen
    missing = [n for n in like._fields if n not in out]
    if missing:
        raise TypeError(f"{kind}: cannot restore fields {missing}")
    return type(like)(**out), payload["meta"]
