"""RGB renderers for the engines (counterpart of ``gymrl_tpu/envs/render.py``).

The reference's ``test()`` runs one human-rendered episode
(dqn_cartpole.py:237-253). Headless, the equivalent is
``render(env, state) -> uint8[H, W, 3]`` frames and ``save_gif``;
``TrainLoop.test(render=True)`` writes the animation under
``./exp/renders/``.

Plain numpy on the host, the JAX package's rasterization line for line, so
the two packages draw the same frame from the same state. A renderer takes
ONE env's state as numpy (``state_row`` takes it out of a batch). PIL is
imported only by ``save_gif``.
"""

from __future__ import annotations

import numpy as np


def state_row(state, i: int = 0):
    """Env ``i`` of a batched port state as numpy: what a renderer takes."""
    return type(state)(*(x[i].detach().cpu().numpy() for x in state))


def _blank(h, w, color=(10, 10, 30)):
    img = np.empty((h, w, 3), np.uint8)
    img[:] = color
    return img


def _fill_poly(img, pts, color):
    """Scanline polygon fill; pts = [(x, y), ...] in pixel coords."""
    h, w, _ = img.shape
    pts = np.asarray(pts, np.float64)
    ys = pts[:, 1]
    y0, y1 = max(int(ys.min()), 0), min(int(ys.max()) + 1, h)
    n = len(pts)
    for y in range(y0, y1):
        xs = []
        for i in range(n):
            x_a, y_a = pts[i]
            x_b, y_b = pts[(i + 1) % n]
            if (y_a <= y < y_b) or (y_b <= y < y_a):
                t = (y - y_a) / (y_b - y_a)
                xs.append(x_a + t * (x_b - x_a))
        xs.sort()
        for j in range(0, len(xs) - 1, 2):
            a, b = max(int(xs[j]), 0), min(int(xs[j + 1]) + 1, w)
            img[y, a:b] = color
    return img


def _line(img, p0, p1, color, width=1):
    h, w, _ = img.shape
    x0, y0 = p0
    x1, y1 = p1
    steps = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    for t in np.linspace(0.0, 1.0, steps):
        x = int(round(x0 + t * (x1 - x0)))
        y = int(round(y0 + t * (y1 - y0)))
        img[max(y - width, 0):min(y + width + 1, h),
            max(x - width, 0):min(x + width + 1, w)] = color
    return img


# -- CartPole -----------------------------------------------------------------

def render_cartpole(state, width=600, height=400):
    """Gym-style view: track, cart, pole from (x, θ)."""
    img = _blank(height, width, (255, 255, 255))
    world_w = 4.8
    scale = width / world_w
    carty = int(height * 0.75)
    _line(img, (0, carty + 22), (width, carty + 22), (0, 0, 0))

    x = float(state.x)
    theta = float(state.theta)
    cartx = int(x * scale + width / 2.0)
    img = _fill_poly(
        img,
        [(cartx - 25, carty - 15), (cartx + 25, carty - 15),
         (cartx + 25, carty + 15), (cartx - 25, carty + 15)],
        (0, 0, 0),
    )
    pole_len = scale * 1.0
    tipx = cartx + pole_len * np.sin(theta)
    tipy = carty - 15 - pole_len * np.cos(theta)
    _line(img, (cartx, carty - 15), (tipx, tipy), (204, 153, 102), width=3)
    return img


# -- LunarLander --------------------------------------------------------------

def render_lunarlander(state, width=600, height=400):
    """Terrain + lander hull + legs, gymnasium viewport geometry."""
    from gymrl_tpu_torch.envs.lunarlander import CHUNKS, HULL_PTS, LEG_PTS, W, H

    img = _blank(height, width, (0, 0, 0))
    sx, sy = width / W, height / H

    def to_px(x, y):
        return (x * sx, height - y * sy)

    terrain = np.asarray(state.terrain)
    chunk_x = [W / (CHUNKS - 1) * i for i in range(CHUNKS)]
    ground = [to_px(x, y) for x, y in zip(chunk_x, terrain)]
    poly = ground + [(width, height), (0, height)]
    _fill_poly(img, poly, (255, 255, 255))

    pos = np.asarray(state.pos)
    angle = float(state.angle)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    hull_w = (HULL_PTS @ rot.T) + pos
    _fill_poly(img, [to_px(x, y) for x, y in hull_w], (128, 102, 230))
    legs_w = (LEG_PTS @ rot.T) + pos
    for i in (0, 2):
        _line(img, to_px(*legs_w[i]), to_px(*legs_w[i + 1]), (77, 77, 128), 2)
    return img


# -- grids --------------------------------------------------------------------

def _render_grid(pos, nrow, ncol, specials, cell=48):
    img = _blank(nrow * cell, ncol * cell, (230, 230, 230))
    for (r, c), color in specials.items():
        img[r * cell:(r + 1) * cell, c * cell:(c + 1) * cell] = color
    for r in range(nrow + 1):
        _line(img, (0, r * cell - 1), (ncol * cell, r * cell - 1), (150, 150, 150))
    for c in range(ncol + 1):
        _line(img, (c * cell - 1, 0), (c * cell - 1, nrow * cell), (150, 150, 150))
    r, c = divmod(int(pos), ncol)
    pad = cell // 4
    img[r * cell + pad:(r + 1) * cell - pad, c * cell + pad:(c + 1) * cell - pad] = (200, 60, 60)
    return img


def render_frozenlake(state):
    holes = {(1, 1), (1, 3), (2, 3), (3, 0)}
    specials = {hc: (40, 60, 140) for hc in holes}
    specials[(3, 3)] = (60, 160, 60)
    return _render_grid(state.pos, 4, 4, specials)


def render_cliffwalking(state):
    specials = {(3, c): (30, 30, 30) for c in range(1, 11)}
    specials[(3, 11)] = (60, 160, 60)
    return _render_grid(state.pos, 4, 12, specials)


RENDERERS = {
    "CartPole-v1": render_cartpole,
    "LunarLander-v2": render_lunarlander,
    "LunarLander-v3": render_lunarlander,
    "FrozenLake-v1": render_frozenlake,
    "CliffWalking-v0": render_cliffwalking,
}


def render(env, state):
    """Dispatch to the env's renderer; returns uint8[H, W, 3] or None."""
    fn = RENDERERS.get(env.name)
    return None if fn is None else fn(state)


def save_gif(frames, path, fps=50):
    """Write an episode animation with PIL."""
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(int(1000 / fps), 20), loop=0)
    return path
