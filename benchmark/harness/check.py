"""Whether what the timed path produced is correct: each sampled image
against the float32 reference (reference/; its T5 in the configuration's
stated bfloat16), after the program's state is freed. The reference
regenerates the planes from the run's seed (the benchmark's own draw) and
works out the rest again; the configuration's family route
(``families/<family>.py``) gives both.

Two numbers are compared, each the largest over the sampled images, one for
each stage of an image:

- ``latent_rel_err``, the encoders and the denoise (every linear,
  attention, the Euler loop): the L2 distance between the packed latent
  that the program's timed path handed to its VAE decode (the route's
  latent tap) and the reference's latent of the same request, over
  the reference latent's L2 norm;
- ``decode_rel_err``, the VAE decode and the u8 conversion: the L2 distance
  between the program's u8 image and the reference's decode of the
  program's own latent, over that reference image's L2 norm about mid-grey
  (127.5). The reference follows the program's state here, so that the
  decode is held to its own precision, apart from the denoise's error that
  the VAE's gain would carry into the image."""

from __future__ import annotations

import gc
import time

import numpy as np

from . import manifest


def rel_err(prog: np.ndarray, ref: np.ndarray) -> float:
    """u8 images: the distance over the reference's norm about mid-grey."""
    p, r = prog.astype(np.float64), ref.astype(np.float64)
    return float(np.linalg.norm(p - r) / max(np.linalg.norm(r - 127.5), 1e-9))


def latent_rel_err(prog, ref) -> float:
    """Latents: the distance over the reference's norm (inf: none taken)."""
    if prog is None:
        return float("inf")
    p = np.asarray(prog, np.float64).reshape(-1)
    r = np.asarray(ref, np.float64).reshape(-1)
    if p.shape != r.shape:
        return float("inf")
    return float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1e-30))


def sample(completed: list, seed: int, n: int, batches=()) -> list:
    """The records to judge, drawn from the seed: the largest image; then,
    where the server stepped lanes together (``batches``: the Futures of
    each forward of two or more lanes), every lane of one such forward whose
    requests all completed, so that each lane of a batch is held to its own
    request whichever of them a fault touches; then others, up to ``n``."""
    if not completed:
        return []
    rng = np.random.default_rng([int(seed), 0xC4EC])
    big = max(range(len(completed)),
              key=lambda i: completed[i]["request"].height * completed[i]["request"].width)
    pick = [big]
    at = {id(rec.get("future")): i for i, rec in enumerate(completed) if "future" in rec}
    whole = [b for b in dict.fromkeys(batches) if all(id(f) in at for f in b)]
    if whole:
        pick += [at[id(f)] for f in whole[rng.integers(len(whole))] if at[id(f)] != big]
    rest = [i for i in range(len(completed)) if i not in pick]
    pick += list(rng.permutation(rest)[:max(0, n - len(pick))])
    return [completed[i] for i in pick]


def judge(cfg: dict, planes: dict, req, lat, img, ref_lat, device) -> dict:
    """Both numbers of one image (``lat`` its latent [S, 64] on the host or
    None, ``img`` its u8 image) against the reference latent ``ref_lat``."""
    import torch

    out = {"latent_rel_err": latent_rel_err(lat, ref_lat), "decode_rel_err": float("inf")}
    if lat is not None and out["latent_rel_err"] != float("inf"):
        x = torch.as_tensor(np.asarray(lat, np.float32), device=device)
        out["decode_rel_err"] = rel_err(img, manifest.route(cfg).decode_u8(cfg, planes, x, req))
    return out


def compare(cfg: dict, seed: int, records: list, device, limits: dict) -> dict:
    """{"correct", "numbers": {name: (value, limit)}, "seconds", "each"}."""
    import torch

    t0 = time.perf_counter()
    if not records:
        return {"correct": False, "numbers": {"images_compared": (0, 1)},
                "seconds": 0.0}
    route = manifest.route(cfg)
    planes = route.planes(cfg, seed, device)
    each = {"latent_rel_err": [], "decode_rel_err": []}
    for rec in records:
        r = rec["request"]
        ref_lat = route.reference_latent(cfg, planes, r, device)
        got = judge(cfg, planes, r, rec.get("latent"), rec["image"], ref_lat.cpu().numpy(),
                    device)
        for k, v in got.items():
            each[k].append(v)
    del planes
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    numbers = {k: (max(v), limits[k]) for k, v in each.items()}
    return {"correct": all(v <= lim for v, lim in numbers.values()), "numbers": numbers,
            "seconds": time.perf_counter() - t0, "each": each}
