"""Auto-streaming trigger, multihost helpers, and scaling-report smoke."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tracs_tpu.io.fasta import write_fasta


def test_auto_streaming_kicks_in(tmp_path, rng, monkeypatch, caplog):
    # >4096 samples: the distance stage must switch to row-block streaming
    from tracs_tpu.stages.distance import main as distance_main

    n, L = 4200, 40
    chars = np.array(list("ACGT"))
    msa = tmp_path / "many.fasta"
    write_fasta(
        msa, ((f"s{i}", "".join(rng.choice(chars, size=L))) for i in range(n))
    )
    out = str(tmp_path / "d.csv")
    monkeypatch.setattr(
        sys, "argv", ["", "--msa", str(msa), "-o", out, "-D", "3"]
    )
    distance_main()
    assert os.path.exists(out)
    with open(out) as fh:
        header = fh.readline()
    assert header.startswith("sampleA,sampleB,")
    assert not os.path.exists(out + ".cursor")  # cleaned up on success


def test_multihost_single_host_noop(monkeypatch):
    from tracs_tpu.parallel.multihost import global_mesh, initialize

    monkeypatch.delenv("TRACS_TPU_COORDINATOR", raising=False)
    assert initialize() is False
    mesh = global_mesh(sp=2)
    assert mesh.shape["sp"] == 2


def test_align_composite_flag_registered():
    import argparse

    from tracs_tpu.stages.align import align_parser

    p = align_parser(argparse.ArgumentParser())
    args = p.parse_args(
        ["-i", "x.fq", "--refseqs", "r.fasta", "-o", "out", "--composite"]
    )
    assert args.composite is True


def test_scaling_report_smoke(tmp_path):
    script = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts", "scaling_report.py",
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    ).strip()
    r = subprocess.run(
        [sys.executable, script, "--n", "12", "--L", "500", "--iters", "1"],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert r.returncode == 0, r.stderr[-800:]
    import json

    out = json.loads(r.stdout.strip().split("\n")[-1])
    assert "1x1" in out["pairs_per_s"]
    assert any(k != "1x1" for k in out["pairs_per_s"])
