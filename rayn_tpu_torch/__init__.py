"""rayn_tpu_torch: the PyTorch + CUDA port of rayn_tpu for NVIDIA Hopper.

The package mirrors rayn_tpu's layout and names. Plain tensor code is
PyTorch; the three kernels of the default render path (closest hit,
shadow sort key, bounce tail) are hand-written CUDA C++ in `csrc/`,
built at first use by `_build`. Every kernel wrapper takes CPU tensors
too and then runs its plain torch twin, which is how the CPU tests run.

    from rayn_tpu_torch.config import RenderSettings
    from rayn_tpu_torch.scene import presets
    from rayn_tpu_torch.render import renderer, film
    data, static, camera = presets.default_scene((1920, 1080), device="cuda")
    f = renderer.render_frame(data, static,
                              RenderSettings(resolution=(1920, 1080), spp=4),
                              camera, frame=1)
    img = film.resolve(f, (1920, 1080))
"""

__version__ = "0.1.0"


def __getattr__(name):
    # rayn_tpu/__init__.py's re-export, imported when first asked for
    if name == "render_frame_sharded":
        from rayn_tpu_torch.parallel.sharding import render_frame_sharded
        return render_frame_sharded
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
