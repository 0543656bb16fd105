"""The port's engine routing (``vaporetto_tpu_torch.utils.routing``).

Mirrors ``tests/test_routing.py`` where the policy carries over: explicit
backends pass through, unknown names are rejected and
``VAPORETTO_TPU_BACKEND`` steers only ``auto``. The port's own policy:
``auto`` is ``device`` on any machine, with no probe of the card and no
look at the input; without a CUDA device the device predictor then
raises an error that names ``--backend host`` (the JAX package resolves
that machine to the host engine), and a caller's ``device="cpu"`` runs
the plain versions. A card is simulated by monkeypatching
``torch.cuda.is_available``.
"""

import threading

import pytest
import torch

from vaporetto_tpu_torch.cli.common import build_predictor
from vaporetto_tpu_torch.utils import routing

from test_scorers import create_test_model
from test_torch_host_reference import port_model


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("VAPORETTO_TPU_BACKEND", raising=False)


@pytest.fixture(scope="module")
def model():
    return port_model(create_test_model())


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _no_threads(monkeypatch):
    def no_thread(*a, **k):
        raise AssertionError("routing started a thread")

    monkeypatch.setattr(threading, "Thread", no_thread)


class TestResolveBackend:
    def test_device_passes_through(self):
        assert routing.resolve_backend("device") == "device"

    def test_explicit_passthrough(self, monkeypatch):
        _no_cuda(monkeypatch)
        assert routing.resolve_backend("device") == "device"
        assert routing.resolve_backend("host") == "host"

    @pytest.mark.parametrize("name", ["gpu", "cuda", "", "Device"])
    def test_unknown_rejected(self, name):
        with pytest.raises(ValueError, match="unknown backend"):
            routing.resolve_backend(name)

    @pytest.mark.parametrize("cuda", [True, False])
    def test_auto_is_device(self, monkeypatch, cuda):
        """With or without a card, auto is the device: no probe runs and
        nothing about the input is asked."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
        _no_threads(monkeypatch)
        assert routing.resolve_backend("auto") == "device"

    @pytest.mark.parametrize("forced", ["device", "auto", "tpu", ""])
    def test_env_override_to_the_device(self, monkeypatch, forced):
        monkeypatch.setenv("VAPORETTO_TPU_BACKEND", forced)
        assert routing.resolve_backend("auto") == "device"

    def test_env_override(self, monkeypatch):
        _no_cuda(monkeypatch)
        monkeypatch.setenv("VAPORETTO_TPU_BACKEND", "device")
        assert routing.resolve_backend("auto") == "device"
        monkeypatch.setenv("VAPORETTO_TPU_BACKEND", "host")
        assert routing.resolve_backend("auto") == "host"

    def test_env_steers_only_auto(self, monkeypatch):
        monkeypatch.setenv("VAPORETTO_TPU_BACKEND", "host")
        assert routing.resolve_backend("device") == "device"
        monkeypatch.setenv("VAPORETTO_TPU_BACKEND", "device")
        assert routing.resolve_backend("host") == "host"


class TestBuildPredictor:
    """What the CLIs construct for each flag on a machine without CUDA."""

    def test_auto_without_cuda_raises(self, monkeypatch, model):
        """The port's departure: no card, no device given -> the
        predictor's no-CUDA error, which names --backend host."""
        _no_cuda(monkeypatch)
        for flag in ("auto", "device"):
            with pytest.raises(RuntimeError, match="--backend host"):
                build_predictor(model, False, flag)
        with pytest.raises(RuntimeError, match="CUDA"):
            build_predictor(model, False, "auto", device="cuda")

    @pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
    def test_auto_on_a_given_cpu_device_is_device(self, monkeypatch, model,
                                                  device):
        _no_cuda(monkeypatch)
        p = build_predictor(model, False, "auto", device=device)
        assert p.backend == "device" and p.device.type == "cpu"

    @pytest.mark.parametrize("how", ["flag", "env"])
    def test_host_needs_no_card(self, monkeypatch, model, how):
        _no_cuda(monkeypatch)
        if how == "env":
            monkeypatch.setenv("VAPORETTO_TPU_BACKEND", "host")
        p = build_predictor(model, True, "host" if how == "flag" else "auto")
        assert p.backend == "host"


def test_cli_default_is_auto():
    import inspect

    from vaporetto_tpu_torch.cli import evaluate, predict

    for mod in (predict, evaluate):
        with pytest.raises(SystemExit):
            mod.main(["--help"])
    for mod in (predict, evaluate):
        assert 'default="auto"' in inspect.getsource(mod.main)
