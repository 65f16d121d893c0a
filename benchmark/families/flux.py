"""The route of the ``flux`` family: FLUX.1 text-to-image (the MMDiT with
T5-XXL, CLIP-L and the 16-channel VAE decoder), one request a prompt, an
image seed and a size.

A route is what the harness, the traffic generators and the check know of a
model family, found by the configuration's ``family`` in
``benchmark/families/<family>.py``:

- ``build_kernels()``: the program's kernel build (seconds);
- ``planes(cfg, seed, device)``: the weights, drawn from the run's seed;
- ``build(cfg, planes, device)``: the system under test and its latent tap;
- ``image(pipe, cfg, req, num_steps=None)``: one request through the timed
  entry at batch 1, its u8 image;
- ``server(pipe, **kw)``: the server and its tap; ``submit(server, cfg,
  req)``: one request to it, its Future;
- ``reference_latent(cfg, planes, req, device, prec=None)``: the reference's
  latent of one request;
- ``decode_u8(cfg, planes, latent, req, prec=None)``: the reference's u8
  image of a latent.

An input of the family's own that a request carries (drawn from its seed,
such as an image to edit) is drawn inside the route, and handed by it to both
the timed entry and the reference. This family has none."""

from __future__ import annotations

from benchmark.harness import planes as _planes, port
from benchmark.reference import pipeline as reference

build_kernels = port.build_kernels


def planes(cfg: dict, seed: int, device) -> dict:
    return _planes.model_planes(cfg, seed, device)


def build(cfg: dict, planes: dict, device):
    """``FluxPipeline`` on the planes, and its ``LatentTap``."""
    pipe = port.build_pipeline(cfg, planes, device)
    return pipe, port.LatentTap(pipe)


def params(cfg: dict, req, num_steps=None):
    return port.generation_params(cfg, req.height, req.width, req.seed, num_steps)


def image(pipe, cfg: dict, req, num_steps=None):
    return pipe.forward_arrays([req.prompt], params(cfg, req, num_steps))[0]


def server(pipe, **kwargs):
    """``FluxServer`` on the pipeline, and its ``ServerTap``."""
    srv = port.server(pipe, **kwargs)
    return srv, port.ServerTap(srv)


def submit(server, cfg: dict, req):
    return server.submit(req.prompt, params(cfg, req))


def reference_latent(cfg: dict, planes: dict, req, device, prec=None):
    """The packed latent after the Euler loop, [S_img, 64] f32."""
    return reference.latent(cfg, planes, req.prompt, req.seed, req.height, req.width, device,
                            prec)[0]


def decode_u8(cfg: dict, planes: dict, latent, req, prec=None):
    """A packed latent [S_img, 64] -> the u8 image [H, W, 3]."""
    return reference.decode_u8(cfg, planes, latent[None], req.height, req.width, prec)
