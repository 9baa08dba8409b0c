"""A frame renderer without GL for the rendering tests, in a module of its
own: a spawned render worker imports the module that holds it, and this one
imports numpy alone."""

import numpy as np


def stub_factory(width, height):
    """A frame renderer whose frame encodes the mean vertex."""
    def render_frame(vertices, faces):
        img = np.zeros((height, width, 3), np.uint8)
        img[0, 0, 0] = int(abs(float(vertices.mean())) * 100) % 255
        return img
    return render_frame
