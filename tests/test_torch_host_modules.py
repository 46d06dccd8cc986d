"""The port's last two host modules against the JAX package's on the same
inputs: utils/datadir_writer (the files it writes, its warnings and
errors) and tools/print_train_val_curve (the log parser over the epoch
lines bin/train writes, the plot, and what it says without matplotlib)."""

import logging
import sys

import pytest

from wesep_tpu.tools import print_train_val_curve as jax_curve
from wesep_tpu.utils.datadir_writer import DatadirWriter as JaxWriter
from wesep_tpu_torch.tools import print_train_val_curve as curve
from wesep_tpu_torch.utils.datadir_writer import DatadirWriter

ROWS = {"spk1.scp": [("utt2", "a/utt2_s1.wav"), ("utt1", "a/utt1_s1.wav")],
        "spk2.scp": [("utt2", "a/utt2_s2.wav"), ("utt1", "a/utt1_s2.wav")],
        "sub/extra.scp": [("utt3", "x y z")]}


def _write(cls, root, rows):
    with cls(root) as writer:
        for name, lines in rows.items():
            node = writer
            for part in name.split("/"):
                node = node[part]
            for key, value in lines:
                node[key] = value


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_datadir_writer_writes_the_jax_packages_files(tmp_path):
    _write(JaxWriter, tmp_path / "jax", ROWS)
    _write(DatadirWriter, tmp_path / "port", ROWS)
    want = _files(tmp_path / "jax")
    assert set(want) == {"spk1.scp", "spk2.scp", "sub/extra.scp"}
    assert _files(tmp_path / "port") == want


def test_datadir_writer_warns_and_raises_as_the_jax_package(tmp_path,
                                                            caplog):
    """A duplicated key warns; sibling files with other keys log a
    mismatch; a file used as a directory, or a directory as a file,
    raises."""
    rows = {"a.scp": [("k1", "1"), ("k1", "2")], "b.scp": [("k2", "3")]}
    for cls, name in ((JaxWriter, "jax"), (DatadirWriter, "port")):
        caplog.clear()
        with pytest.warns(UserWarning, match="duplicated key: k1"), \
                caplog.at_level(logging.WARNING):
            _write(cls, tmp_path / name, rows)
        assert "keys mismatch between a.scp and b.scp" in caplog.text, name
        writer = cls(tmp_path / name / "c")
        writer["f.scp"]["k"] = "v"
        with pytest.raises(RuntimeError, match="points to a dir"):
            writer["k"] = "v"
        with pytest.raises(RuntimeError, match="points to a file"):
            writer["f.scp"]["sub"]
        writer.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def _log(path):
    """Epoch lines as bin/train logs them ("Epoch %d train_loss %.4f
    val_loss %.4f"), among other lines."""
    lines = ["2026-01-01 00:00:00 [INFO] start_epoch: 1"]
    for epoch, (tr, va) in enumerate([(12.5, 10.25), (-3.0625, -4.5),
                                      (-8.75, -9.125)], 1):
        lines += [f"2026-01-01 00:00:0{epoch} [INFO] |   TRAIN    |     "
                  f"{epoch}      |     1      |   {tr:.4g}    |",
                  f"2026-01-01 00:00:0{epoch} [INFO] Epoch {epoch} "
                  f"train_loss {tr:.4f} val_loss {va:.4f}"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_log_parser_reads_what_the_jax_parser_reads(tmp_path):
    log = _log(tmp_path / "train.log")
    got = curve.parse_log(log)
    assert got == jax_curve.parse_log(log)
    assert got == ([1, 2, 3], [12.5, -3.0625, -8.75], [10.25, -4.5, -9.125])
    empty = tmp_path / "empty.log"
    empty.write_text("no epochs here\n")
    assert curve.parse_log(str(empty)) == jax_curve.parse_log(str(empty))
    with pytest.raises(SystemExit, match="no epoch lines"):
        curve.main([str(empty), str(tmp_path / "x.png")])


def test_plot_and_a_missing_matplotlib(tmp_path, monkeypatch, capsys):
    """The plot is written as the JAX tool writes it (a PNG, the same
    message); without matplotlib the tool exits saying so."""
    log = _log(tmp_path / "train.log")
    out = tmp_path / "port.png"
    curve.main([log, str(out)])
    said = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["x", log, str(tmp_path / "jax.png")])
    jax_curve.main()
    assert capsys.readouterr().out == said.replace("port.png", "jax.png")
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="needs matplotlib"):
        curve.main([log, str(tmp_path / "none.png")])
    assert not (tmp_path / "none.png").exists()
