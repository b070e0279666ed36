"""Plotting utilities: random categorical colormap + GIF builder.

A copy of ``vqvae_speech_tpu/eval/utils.py`` (the port imports nothing of
the JAX package): capability-parity with reference
src/evaluation/utils.py:35-160. matplotlib is imported inside each function.
"""
import numpy as np


def rand_cmap(nlabels: int, seed: int = 0, luminosity=(0.3, 0.9)):
    """Random categorical matplotlib colormap with `nlabels` distinct hues
    shuffled for neighbor contrast (reference utils.py:35-120)."""
    import colorsys

    from matplotlib.colors import LinearSegmentedColormap

    rng = np.random.default_rng(seed)
    hues = np.linspace(0, 1, nlabels, endpoint=False)
    rng.shuffle(hues)
    colors = [
        colorsys.hls_to_rgb(h, rng.uniform(*luminosity), rng.uniform(0.6, 1.0))
        for h in hues
    ]
    return LinearSegmentedColormap.from_list("rand_cmap", colors, N=nlabels)


def build_gif(image_paths, output_path: str, fps: int = 2):
    """Assemble saved figure PNGs into a GIF (reference utils.py:122-160)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.animation as animation
    import matplotlib.image as mpimg

    images = [mpimg.imread(p) for p in image_paths]
    fig = plt.figure(figsize=(8, 8))
    plt.axis("off")
    im = plt.imshow(images[0])

    def update(i):
        im.set_data(images[i])
        return [im]

    anim = animation.FuncAnimation(fig, update, frames=len(images))
    anim.save(output_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return output_path
