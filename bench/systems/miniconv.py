"""The system under test for a MiniConv configuration: the port's
``Deployment``, built from the configuration's manifest, deciding one
tick at a time.

A tick takes one batch of frames that already lie on the device, calls
``Deployment.split.edge_step_batch`` (the encoder, then per-example uint8
quantisation), hands the payload to ``Deployment.server_batch_fn`` (decode,
projection, activation) and copies the outputs into a pinned host buffer,
as a server sends them back.  ``dispatch`` enqueues all of it and
``wait`` blocks until the outputs are on the host.
"""
from __future__ import annotations

import contextlib

import torch


def _no_span(name):
    return contextlib.nullcontext()


def set_precision(config: dict) -> None:
    """Serve in the precision the configuration states: the port's
    MiniConv path computes in float32, with TF32 as ``tf32`` says."""
    if config.get("dtype") != "float32":
        raise ValueError(f"{config['name']}: dtype {config.get('dtype')!r};"
                         f" the MiniConv path serves float32")
    torch.backends.cuda.matmul.allow_tf32 = bool(config.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(config.get("tf32", False))


class System:
    """The program for one configuration and cell, on ``device``."""

    def __init__(self, config: dict, cell: dict, device):
        from repro_torch.deploy import Deployment, DeploymentConfig
        from repro_torch.kernels import _build, miniconv_pass
        set_precision(config)
        m, p = config["manifest"], cell["params"]
        self.frames_per_tick = p["frames_per_tick"]
        cfg = DeploymentConfig.standard(
            k=m["k"], c_in=m["c_in"], h=m["h"], backend=m["backend"],
            codec=m["codec"], head_dim=m["head_dim"], head_act=m["head_act"],
            max_batch=self.frames_per_tick)
        got = [dict(kernel=l.kernel, stride=l.stride, c_in=l.c_in,
                    c_out=l.c_out, activation=l.activation)
               for l in cfg.spec.layers]
        if got != config["encoder"]["layers"]:
            raise ValueError(f"the program's encoder {got} is not the "
                             f"configuration's {config['encoder']['layers']}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            _build.build(["miniconv_encoder"])
        self.dep = Deployment.build(cfg, device=self.device)
        self._counted = (miniconv_pass.miniconv_encoder,
                         miniconv_pass.miniconv_encoder_stream)
        self._start = [f.launches for f in self._counted]
        self.payload = None

    @property
    def build_log(self) -> tuple:
        return self.dep.build_log

    def bind(self, inputs: dict) -> None:
        """Serve with the benchmark's weights and frames (the same tensors
        the reference reads)."""
        params = {
            "edge": {f"layer{i}": {"kernel": w, "bias": b}
                     for i, (w, b) in enumerate(inputs["layers"])},
            "server": {"proj": {"kernel": inputs["proj"][0],
                                "bias": inputs["proj"][1]}},
        }
        self.edge_params = params["edge"]
        self.server = self.dep.server_batch_fn(params)
        self.pool = inputs["frames"]
        d = inputs["proj"][0].shape[1]
        self.host = torch.empty((self.frames_per_tick, d),
                                dtype=torch.float32,
                                pin_memory=self.device.type == "cuda")

    def dispatch(self, tick: int, span=_no_span) -> int:
        """Enqueue tick ``tick``; returns the pool batch it decides."""
        idx = tick % self.pool.shape[0]
        with torch.inference_mode():
            with span("edge"):
                payload = self.dep.split.edge_step_batch(self.edge_params,
                                                         self.pool[idx])
            with span("server"):
                z = self.server(payload)
            with span("fetch"):
                self.host.copy_(z, non_blocking=True)
        self.payload = payload
        return idx

    def wait(self) -> None:
        """Block until the last dispatched tick's outputs are on the
        host."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def keep(self) -> dict:
        """The last tick's answers, copied to the host for the check."""
        p = self.payload
        return {"codes": p["data"].cpu(), "scale": p["scale"].cpu(),
                "zero": p["zero"].cpu(), "z": self.host.clone()}

    def counters(self) -> dict:
        """The program's launch counters since this system was built."""
        return {f.__name__ + ".launches": f.launches - s
                for f, s in zip(self._counted, self._start)}

    def close(self) -> None:
        """Drop the program's state: the deployment, the served payload
        and the host buffer."""
        self.dep = self.server = self.payload = self.host = None
        self.edge_params = self.pool = None


__all__ = ["System", "set_precision"]
