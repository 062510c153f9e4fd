"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its phase
functions hold at tiny sizes (device-route archive == host-route archive,
bit-exact round trips), with the device route forced since the CPU
backend's default placement is the host."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

ROUTES = {"device": chip_smoke.FORCED_DEVICE_ROUTE,
          "host": chip_smoke.HOST_ROUTE}


def test_main_refuses_cpu_backend(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""                 # no result line of any kind
    assert "GPU" in out.err


@pytest.fixture(scope="module")
def tiny_inputs(tmp_path_factory):
    chip_smoke._listen()
    work = str(tmp_path_factory.mktemp("smoke"))
    return work, chip_smoke.make_inputs(work, 300_000, 7_000, n_pe=300,
                                        n_adapt=400, n_align=600)


def test_phase_codec_se_frozen_and_extract(tiny_inputs):
    work, inp = tiny_inputs
    # 1 MB blocks put the 2.1 MB input past the usemodel gate
    rec = chip_smoke.phase_codec("a", [inp["se"]], work, 7_000,
                                 routes=ROUTES, extract=True,
                                 flags=["--block-mb", "1"])
    assert rec["device compress cold"]["programs"] > 0
    assert "host extract warm" in rec


@pytest.mark.parametrize("phase", ["b", "c"])
def test_phase_codec_adaptive_and_pe(tiny_inputs, phase):
    work, inp = tiny_inputs
    args = (([inp["adapt"]], 400) if phase == "b" else (inp["pe"], 300))
    rec = chip_smoke.phase_codec(phase, args[0], work, args[1],
                                 routes=ROUTES)
    assert set(rec) >= {"device compress warm", "host decompress warm"}


def test_phase_aligned(tiny_inputs):
    work, inp = tiny_inputs
    rec = chip_smoke.phase_aligned(inp["fa"], inp["align"], work, 600,
                                   routes=ROUTES)
    assert "device compress fused-align" in rec


def test_phase_mesh_four_devices(tiny_inputs):
    """--cards 4 phase on four of the virtual CPU devices: mesh payloads
    equal the one-device archive's, mesh and ctx-sharded decode exact."""
    work, inp = tiny_inputs
    rec = chip_smoke.phase_mesh(inp["se"], work, 7_000, 4,
                                flags=["--block-mb", "1"])
    assert rec["device compress mesh cold"]["programs"] > 0


def test_phase_sharded_index_four_devices(tiny_inputs, monkeypatch):
    import jax
    monkeypatch.setattr(jax, "devices", lambda *a: jax.local_devices()[:4])
    work, inp = tiny_inputs
    rec = chip_smoke.phase_sharded_index(inp["fa"], inp["align"], work, 600)
    assert rec["device compress sharded cold"]["programs"] > 0
    # the shards are placed and the batch program built once per aligner
    assert rec["device compress sharded warm"]["programs"] == 0


def test_default_route_unsets_placement_overrides(monkeypatch):
    """The device route runs with the placement overrides removed, so an
    override left in the environment cannot turn it into a host route."""
    for var in chip_smoke.HOST_ROUTE:
        monkeypatch.setenv(var, "host")
    with chip_smoke._env(chip_smoke.DEFAULT_ROUTE):
        assert not any(v in os.environ for v in chip_smoke.HOST_ROUTE)
    assert all(os.environ[v] == "host" for v in chip_smoke.HOST_ROUTE)


def test_phase_fails_when_no_device_program_ran():
    rec = {"device compress warm": {"programs": 0},
           "host compress cold": {"programs": 3}}
    with pytest.raises(RuntimeError, match="no device program"):
        chip_smoke._check_device_ran("x", rec)


def test_counts_scale_cuts_reads_only(capsys):
    n = chip_smoke._counts(0.01)
    assert n == {"se": 10_000, "adapt": 1_000, "pe": 2_500, "align": 5_000}
    assert capsys.readouterr().out.count("cut:") == 4
    assert chip_smoke._counts(1.0)["se"] == chip_smoke.N_SE
