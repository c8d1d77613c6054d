"""Release artifacts: write and load the deployable inference bundle.

The same on-disk layout as code2vec_tpu/release/artifact.py, so either
package serves what the other wrote:

    release_meta.json            kind/format/quantization/dims/buckets/
                                 fingerprint
    dictionaries.bin             the three vocabularies (vocab.py)
    <table>.npy                  int8 (V, D); uint8 fp8 bit patterns
                                 (V, D); uint8 packed int4 (V, ceil(D/2));
                                 or f32 for scheme float32
    <table>.scale.npy            f32 (V, 1) per-row scales (quantized
                                 schemes)
    transform.npy, attention.npy f32 dense params

for the tables token_embedding, path_embedding and target_embedding.
`load_artifact` validates as the reference does and raises ArtifactError
naming the offending field. Every scheme the reference writes is written
and served: int8, fp8 e4m3 and e5m2, packed int4 and float32.
`export_artifact` writes one from a live training facade (the `export`
command), without the reference's AOT lowerings and MIPS crossover
calibration.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from code2vec_tpu_torch.ops import quant

META_NAME = "release_meta.json"
DICT_NAME = "dictionaries.bin"
ARTIFACT_FORMAT = 1
ARTIFACT_KIND = "code2vec_release_artifact"
SCHEME_INT8 = "int8_rowwise_symmetric"
SCHEME_FP8_E4M3 = "fp8_e4m3_rowwise"
SCHEME_FP8_E5M2 = "fp8_e5m2_rowwise"
SCHEME_INT4 = "int4_rowwise_packed"
SCHEME_FP32 = "float32"
QUANTIZED_SCHEMES = (SCHEME_INT8, SCHEME_FP8_E4M3, SCHEME_FP8_E5M2,
                     SCHEME_INT4)
ALL_SCHEMES = QUANTIZED_SCHEMES + (SCHEME_FP32,)
# the on-disk uint8 bit patterns of an fp8 scheme's tables, viewed at
# load as the format they encode (code2vec_tpu/release/runtime.py:312-352)
FP8_TABLE_DTYPES = {SCHEME_FP8_E4M3: quant.FP8_DTYPES["e4m3"],
                    SCHEME_FP8_E5M2: quant.FP8_DTYPES["e5m2"]}
SCHEME_BY_KNOB = {"int8": SCHEME_INT8, "fp8_e4m3": SCHEME_FP8_E4M3,
                  "fp8_e5m2": SCHEME_FP8_E5M2, "int4": SCHEME_INT4,
                  "float32": SCHEME_FP32}

_TABLES = ("token_embedding", "path_embedding", "target_embedding")
_DENSE = ("transform", "attention")


def _quantize_table(table: np.ndarray, scheme: str):
    """(payload, scales or None) of one table under `scheme`
    (code2vec_tpu/release/artifact.py:77-89)."""
    if scheme == SCHEME_INT8:
        return quant.quantize_rows(table)
    if scheme == SCHEME_FP8_E4M3:
        return quant.quantize_rows_fp8(table, "e4m3")
    if scheme == SCHEME_FP8_E5M2:
        return quant.quantize_rows_fp8(table, "e5m2")
    if scheme == SCHEME_INT4:
        return quant.quantize_rows_int4(table)
    if scheme != SCHEME_FP32:
        raise ValueError(f"unknown artifact scheme {scheme!r} (one of "
                         f"{list(ALL_SCHEMES)})")
    return table, None


def table_dim(dims: dict, name: str) -> int:
    """Unpacked (model-side) column count of one embedding table."""
    d_tok, d_path = int(dims["token_dim"]), int(dims["path_dim"])
    return {"token_embedding": d_tok, "path_embedding": d_path,
            "target_embedding": d_path + 2 * d_tok}[name]


class ArtifactError(ValueError):
    """Artifact rejected with the offending meta/table field named."""

    def __init__(self, field: str, message: str):
        super().__init__(f"release artifact field `{field}`: {message}")
        self.field = field


@dataclasses.dataclass
class ReleaseArtifact:
    path: str
    meta: dict
    tables: Dict[str, np.ndarray]   # quantized tables carry "<name>.scale"

    @property
    def scheme(self) -> str:
        return self.meta["quantization"]["scheme"]

    @property
    def fingerprint(self) -> str:
        return self.meta["fingerprint"]

    @property
    def dictionaries_path(self) -> str:
        return os.path.join(self.path, DICT_NAME)

    def table_bytes(self) -> int:
        return sum(a.nbytes for a in self.tables.values())


def _content_fingerprint(payloads: Mapping[str, np.ndarray],
                         meta: dict) -> str:
    """sha256 over the identity-bearing meta core and the table payloads:
    the same digest code2vec_tpu/release/artifact.py:136 computes."""
    h = hashlib.sha256()
    core = {k: meta[k] for k in ("kind", "format", "quantization", "dims",
                                 "max_contexts", "compute_dtype")}
    h.update(json.dumps(core, sort_keys=True).encode())
    for name in sorted(payloads):
        arr = np.ascontiguousarray(payloads[name])
        h.update(f"{name}:{arr.dtype}:{arr.shape}".encode())
        h.update(arr.data)
    return h.hexdigest()


def write_artifact(params: Mapping[str, np.ndarray], vocabs, out_dir: str,
                   scheme: str = "int8", *, max_contexts: int = 200,
                   compute_dtype: str = "bfloat16", topk: int = 10,
                   topk_block_size: int = 4096, serve_batch_size: int = 64,
                   buckets: Sequence[int] = (32, 64, 128, 200),
                   separate_oov_and_pad: bool = False,
                   real_target_vocab_size: Optional[int] = None,
                   source: Optional[dict] = None) -> dict:
    """Write a release artifact from f32 numpy params (the Flax names and
    shapes) in the layout of the reference's `export_artifact`; returns
    the meta. `scheme` is a knob name ("int8", "fp8_e4m3", "fp8_e5m2",
    "int4", "float32") or an on-disk name; `source` records the
    checkpoint, step and epoch the params came from."""
    scheme = SCHEME_BY_KNOB.get(scheme, scheme)
    if scheme not in ALL_SCHEMES:
        raise ValueError(f"unknown artifact scheme {scheme!r} (one of "
                         f"{list(ALL_SCHEMES)})")
    os.makedirs(out_dir, exist_ok=True)
    payloads: Dict[str, np.ndarray] = {}
    fp32_bytes = written = 0
    for name in _TABLES:
        table = np.asarray(params[name], np.float32)
        fp32_bytes += table.nbytes
        scale_path = os.path.join(out_dir, f"{name}.scale.npy")
        q, scales = _quantize_table(table, scheme)
        np.save(os.path.join(out_dir, f"{name}.npy"), q)
        payloads[name] = q
        written += q.nbytes
        if scales is not None:
            np.save(scale_path, scales)
            payloads[f"{name}.scale"] = scales
            written += scales.nbytes
        elif os.path.exists(scale_path):
            os.remove(scale_path)
    for name in _DENSE:
        arr = np.asarray(params[name], np.float32)
        np.save(os.path.join(out_dir, f"{name}.npy"), arr)
        payloads[name] = arr
    vocabs.save(os.path.join(out_dir, DICT_NAME))
    tv = vocabs.target_vocab
    target_rows = int(payloads["target_embedding"].shape[0])
    meta = {
        "kind": ARTIFACT_KIND,
        "format": ARTIFACT_FORMAT,
        "quantization": {"scheme": scheme},
        "dims": {
            "token_vocab_size": int(payloads["token_embedding"].shape[0]),
            "path_vocab_size": int(payloads["path_embedding"].shape[0]),
            "target_vocab_size": target_rows,
            "real_target_vocab_size": int(real_target_vocab_size
                                          or target_rows),
            # the unpacked widths (an int4 payload is half as wide)
            "token_dim": int(np.shape(params["token_embedding"])[1]),
            "path_dim": int(np.shape(params["path_embedding"])[1]),
            "target_oov_floor": max(tv.pad_index, tv.oov_index),
        },
        "separate_oov_and_pad": bool(separate_oov_and_pad),
        "compute_dtype": compute_dtype,
        "max_contexts": int(max_contexts),
        "topk": int(topk),
        "topk_block_size": int(topk_block_size),
        "serve_batch_size": int(serve_batch_size),
        "buckets": [int(b) for b in buckets],
        "source": dict(source or {"checkpoint": None, "step": 0,
                                  "epoch": None}),
        "table_bytes": {"fp32": fp32_bytes, "artifact": written},
        "aot": None,
    }
    meta["fingerprint"] = _content_fingerprint(payloads, meta)
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
        f.write("\n")
    return meta


def export_artifact(model, out_dir: str, *, quantize: Optional[bool] = None,
                    scheme: Optional[str] = None, log=None) -> dict:
    """Write a release artifact from a live facade model (the `export`
    command; reference :155-265); returns its meta. `scheme` is an
    on-disk scheme name; unset, it follows config.release_scheme, with
    `quantize` False (--no_quantize) forcing float32 tables."""
    config = model.config
    log = log or config.log
    quantize = config.release_quantize if quantize is None else quantize
    if scheme is None:
        scheme = (SCHEME_BY_KNOB[config.release_scheme] if quantize
                  else SCHEME_FP32)
    params = {k: v.detach().cpu().numpy()
              for k, v in model.state.params.items()}
    meta = write_artifact(
        params, model.vocabs, out_dir, scheme,
        max_contexts=config.max_contexts,
        compute_dtype=config.compute_dtype,
        topk=config.top_k_words_considered_during_prediction,
        topk_block_size=config.topk_block_size,
        serve_batch_size=config.serve_batch_size,
        buckets=model.context_buckets,
        separate_oov_and_pad=config.separate_oov_and_pad,
        real_target_vocab_size=model.dims.real_target_vocab_size,
        source={"checkpoint": (os.path.abspath(config.model_load_path)
                               if config.model_load_path else None),
                "step": int(model.state.step),
                "epoch": model.initial_epoch})
    log(f"Release artifact written to {out_dir}: scheme {scheme}, "
        f"{meta['table_bytes']['artifact'] / 1e6:.1f} MB of tables "
        f"({meta['table_bytes']['fp32'] / 1e6:.1f} MB as float32), "
        f"fingerprint {meta['fingerprint'][:12]}")
    return meta


def _expected_dtype(scheme: str, name: str) -> np.dtype:
    if name.endswith(".scale") or name in _DENSE:
        return np.dtype(np.float32)
    if scheme == SCHEME_INT8:
        return np.dtype(np.int8)
    if scheme in (SCHEME_FP8_E4M3, SCHEME_FP8_E5M2, SCHEME_INT4):
        return np.dtype(np.uint8)
    return np.dtype(np.float32)


def _expected_shape(dims: dict, name: str, scheme: str) -> tuple:
    d_tok, d_path = int(dims["token_dim"]), int(dims["path_dim"])
    code_dim = d_path + 2 * d_tok
    shape = {
        "token_embedding": (int(dims["token_vocab_size"]), d_tok),
        "path_embedding": (int(dims["path_vocab_size"]), d_path),
        "target_embedding": (int(dims["target_vocab_size"]), code_dim),
        "transform": (code_dim, code_dim),
        "attention": (code_dim, 1),
    }[name]
    if scheme == SCHEME_INT4 and name in _TABLES:
        return (shape[0], (shape[1] + 1) // 2)
    return shape


def load_artifact(path: str) -> ReleaseArtifact:
    """Load and validate a release artifact (tables memory-mapped), with
    the checks of code2vec_tpu/release/artifact.py:321."""
    base = os.path.abspath(path)
    meta_path = os.path.join(base, META_NAME)
    if not os.path.isfile(meta_path):
        raise ArtifactError(
            "kind", f"{base} is not a release artifact ({META_NAME} "
            f"missing); artifacts are produced by the `export` subcommand "
            f"of code2vec_tpu or by write_artifact")
    with open(meta_path) as f:
        try:
            meta = json.load(f)
        except json.JSONDecodeError as e:
            raise ArtifactError("kind", f"unparseable {META_NAME}: {e}")
    if meta.get("kind") != ARTIFACT_KIND:
        raise ArtifactError("kind", f"expected {ARTIFACT_KIND!r}, "
                                    f"got {meta.get('kind')!r}")
    if int(meta.get("format", -1)) > ARTIFACT_FORMAT:
        raise ArtifactError(
            "format", f"artifact format {meta.get('format')} is newer "
            f"than this build understands (<= {ARTIFACT_FORMAT})")
    scheme = (meta.get("quantization") or {}).get("scheme")
    if scheme not in ALL_SCHEMES:
        raise ArtifactError(
            "quantization.scheme",
            f"unknown scheme {scheme!r} (this build understands "
            f"{list(ALL_SCHEMES)})")
    if "fingerprint" not in meta:
        raise ArtifactError("fingerprint", "missing (torn export?)")
    for key in ("compute_dtype", "topk", "serve_batch_size",
                "max_contexts", "separate_oov_and_pad", "buckets"):
        if key not in meta:
            raise ArtifactError(
                key, f"missing from {META_NAME} (torn or hand-edited "
                     f"export?)")
    if not os.path.isfile(os.path.join(base, DICT_NAME)):
        raise ArtifactError("dictionaries", f"{DICT_NAME} missing")
    dims = meta.get("dims") or {}
    missing = {"token_vocab_size", "path_vocab_size", "target_vocab_size",
               "real_target_vocab_size", "target_oov_floor",
               "token_dim", "path_dim"} - dims.keys()
    if missing:
        raise ArtifactError("dims", f"missing field(s) {sorted(missing)}")
    tables: Dict[str, np.ndarray] = {}
    for name in _TABLES + _DENSE:
        p = os.path.join(base, f"{name}.npy")
        if not os.path.isfile(p):
            raise ArtifactError(name, "table file missing")
        arr = np.load(p, mmap_mode="r")
        want = _expected_dtype(scheme, name)
        if arr.dtype != want:
            raise ArtifactError(
                f"{name}.dtype",
                f"expected {want} under quantization.scheme={scheme}, "
                f"file holds {arr.dtype}")
        want_shape = _expected_shape(dims, name, scheme)
        if tuple(arr.shape) != want_shape:
            raise ArtifactError(
                f"{name}.shape",
                f"expected {want_shape} per meta dims, file holds "
                f"{tuple(arr.shape)}")
        tables[name] = arr
        if scheme in QUANTIZED_SCHEMES and name in _TABLES:
            sp = os.path.join(base, f"{name}.scale.npy")
            if not os.path.isfile(sp):
                raise ArtifactError(f"{name}.scale", "scale file missing")
            scales = np.load(sp, mmap_mode="r")
            if scales.dtype != np.float32 or scales.shape != (arr.shape[0], 1):
                raise ArtifactError(
                    f"{name}.scale",
                    f"expected float32 ({arr.shape[0]}, 1), got "
                    f"{scales.dtype} {scales.shape}")
            tables[f"{name}.scale"] = scales
    return ReleaseArtifact(path=base, meta=meta, tables=tables)
