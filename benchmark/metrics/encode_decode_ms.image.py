"""T5 + CLIP encode plus VAE decode per image of the window
(FluxPipeline.timings), ms."""


def read(run):
    done = run.out.get("completed", [])
    if not done:
        return None
    return 1e3 * sum(d["timings"]["encode_s"] + d["timings"]["decode_s"]
                     for d in done) / len(done)
