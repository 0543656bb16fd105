"""The port's engine routing (``vaporetto_tpu_torch.utils.routing``).

Mirrors ``tests/test_routing.py`` where the policy carries over while the
port has no native host engine: explicit ``device`` passes through,
``auto`` resolves to the device, ``VAPORETTO_TPU_BACKEND`` steers only
``auto``, and ``host`` (the flag or the environment) is an error that
names the unported engine.
"""

import pytest

from vaporetto_tpu_torch.utils import routing


class TestResolveBackend:
    def test_device_passes_through(self):
        assert routing.resolve_backend("device") == "device"

    @pytest.mark.parametrize("name", ["gpu", "cuda", "", "Device"])
    def test_unknown_rejected(self, name):
        with pytest.raises(ValueError, match="unknown backend"):
            routing.resolve_backend(name)

    def test_auto_without_the_host_engine_is_device(self, monkeypatch):
        monkeypatch.delenv("VAPORETTO_TPU_BACKEND", raising=False)
        assert routing.resolve_backend("auto") == "device"

    def test_host_is_rejected_without_the_engine(self):
        with pytest.raises(routing.HostEngineNotPorted,
                           match="host_predictor"):
            routing.resolve_backend("host")
        assert isinstance(routing.HostEngineNotPorted(), NotImplementedError)

    @pytest.mark.parametrize("forced", ["device", "auto", "tpu"])
    def test_env_override_to_the_device(self, monkeypatch, forced):
        monkeypatch.setenv("VAPORETTO_TPU_BACKEND", forced)
        assert routing.resolve_backend("auto") == "device"

    def test_env_override_to_the_host_is_rejected(self, monkeypatch):
        monkeypatch.setenv("VAPORETTO_TPU_BACKEND", "host")
        with pytest.raises(routing.HostEngineNotPorted):
            routing.resolve_backend("auto")

    def test_env_steers_only_auto(self, monkeypatch):
        monkeypatch.setenv("VAPORETTO_TPU_BACKEND", "host")
        assert routing.resolve_backend("device") == "device"


def test_cli_default_is_auto():
    from vaporetto_tpu_torch.cli import evaluate, predict

    for mod in (predict, evaluate):
        with pytest.raises(SystemExit):
            mod.main(["--help"])
    import inspect

    for mod in (predict, evaluate):
        assert 'default="auto"' in inspect.getsource(mod.main)
