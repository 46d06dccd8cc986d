"""List, scp and kaldi-vector I/O (the subset of
wesep_tpu/utils/file_utils.py that bin/infer and bin/train use)."""

import json
import struct
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["read_lists", "read_2columns_text", "read_label_file",
           "read_vec_scp_file", "write_vec_ark_scp", "norm_embeddings",
           "load_speaker_embeddings", "read_spk2enroll_json"]


def read_lists(path: str) -> List[str]:
    """One entry per non-empty line."""
    with open(path, "r", encoding="utf8") as f:
        return [line.strip() for line in f if line.strip()]


def read_2columns_text(path: str) -> Dict[str, str]:
    """'key value' lines -> {key: value}."""
    out = {}
    with open(path, "r", encoding="utf8") as f:
        for line in f:
            sps = line.rstrip().split(maxsplit=1)
            out[sps[0]] = sps[1] if len(sps) > 1 else ""
    return out


read_label_file = read_2columns_text


def _read_kaldi_binary(f) -> np.ndarray:
    """Parse one kaldi binary object ('\\0B' + FV/FM/DV/DM)."""
    binary = f.read(2)
    if binary != b"\x00B":
        raise ValueError(f"not kaldi binary: {binary!r}")
    token = b""
    while True:
        c = f.read(1)
        if c in (b" ", b""):
            break
        token += c
    token = token.decode()
    if token not in ("FV", "DV", "FM", "DM"):
        raise ValueError(f"unsupported kaldi token {token!r}")
    dtype = np.float32 if token[0] == "F" else np.float64
    dims = []
    for _ in range(1 if token[1] == "V" else 2):
        if f.read(1) != b"\x04":
            raise ValueError("corrupt kaldi dimension header")
        dims.append(struct.unpack("<i", f.read(4))[0])
    count = int(np.prod(dims))
    data = np.frombuffer(f.read(count * np.dtype(dtype).itemsize), dtype)
    return data.reshape(dims).copy()


def read_vec_scp_file(scp_file: str) -> Dict[str, np.ndarray]:
    """'utt ark_path:offset' scp -> {utt: vector}."""
    out = {}
    for utt, rxspec in read_2columns_text(scp_file).items():
        path, _, offset = rxspec.rpartition(":")
        with open(path, "rb") as f:
            f.seek(int(offset))
            out[utt] = _read_kaldi_binary(f)
    return out


def write_vec_ark_scp(base_path: str, vectors: Dict[str, np.ndarray]):
    """Write {utt: vec} to base.ark + base.scp (kaldi binary FV)."""
    ark_path = base_path + ".ark"
    scp_path = base_path + ".scp"
    with open(ark_path, "wb") as ark, open(scp_path, "w") as scp:
        for utt, vec in vectors.items():
            vec = np.asarray(vec, np.float32).reshape(-1)
            ark.write(utt.encode() + b" ")
            offset = ark.tell()
            ark.write(b"\x00BFV \x04")
            ark.write(struct.pack("<i", vec.shape[0]))
            ark.write(vec.tobytes())
            scp.write(f"{utt} {ark_path}:{offset}\n")
    return ark_path, scp_path


def norm_embeddings(embeddings: np.ndarray, kaldi_style: bool = True):
    """Scale to unit L2 norm, times sqrt(dim) in kaldi style."""
    scale = np.sqrt(embeddings.shape[-1]) if kaldi_style else 1.0
    norm = np.linalg.norm(embeddings, axis=-1, keepdims=True)
    return scale * embeddings / np.maximum(norm, 1e-12)


def load_speaker_embeddings(
    scp_file: str, utt2spk_file: str
) -> Dict[str, List[np.ndarray]]:
    """spk -> [embedding [1, E], ...] over the speaker's utterances."""
    utt_to_embed = read_vec_scp_file(scp_file)
    utt_to_spk = read_label_file(utt2spk_file)
    out: Dict[str, List[np.ndarray]] = {}
    for utt, embed in utt_to_embed.items():
        out.setdefault(utt_to_spk[utt], []).append(embed[None, :])
    return out


def read_spk2enroll_json(path: str) -> Tuple[Dict, Dict]:
    """spk2enroll.json {spk: [(utt, wav path), ...]} and the speaker-to-id
    map over its sorted speakers."""
    with open(path, "r", encoding="utf8") as f:
        spk2enroll = json.load(f)
    dict_spk = {spk: i for i, spk in enumerate(sorted(spk2enroll.keys()))}
    return spk2enroll, dict_spk
