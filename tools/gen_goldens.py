#!/usr/bin/env /usr/bin/python3
"""Generate oracle golden files under tests/golden/ .

Run with the system python that has OpenCV 4.6 **contrib** (cv2.linemod,
cv2.rgbd, cv2.ppf_match_3d):

    /usr/bin/python3 tools/gen_goldens.py [section ...]

Sections: dn (depth-normal quantize), geom (depthTo3d / rescale / FALS),
cg (color-gradient quantize), icp, match. Default: all.

Goldens are committed so the JAX-side tests do not depend on the oracle at
runtime.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import cv2  # noqa: E402
import numpy as np  # noqa: E402

import scenes  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "golden")
os.makedirs(OUT, exist_ok=True)


def save(name, **arrs):
    path = os.path.join(OUT, name + ".npz")
    np.savez_compressed(path, **arrs)
    print("wrote", path, {k: (v.shape, str(v.dtype)) for k, v in arrs.items()})


def gen_dn():
    dn = cv2.linemod_DepthNormal.create(2000, 50, 63, 2)
    out = {}
    cases = {}
    cases["rand"] = scenes.noisy_depth(48, 64, seed=0)
    cases["rand2"] = scenes.noisy_depth(96, 128, seed=7)
    sphere_depth, _, _ = scenes.sphere_scene()
    cases["sphere640"] = sphere_depth
    z = scenes.noisy_depth(48, 64, seed=3)
    z[10:20, 10:20] = 0
    cases["holes"] = z
    f = scenes.noisy_depth(48, 64, seed=4)
    f[5:15, 30:50] = 2500  # beyond distance_threshold
    cases["far"] = f
    for az in (0, 37, 101, 215, 303):
        cases[f"ramp{az}"] = scenes.ramp_depth(az)
    for name, dep in cases.items():
        out[name + "_in"] = dep
        out[name + "_q"] = dn.process(dep).quantize()
    save("dn_quantize", **out)


def gen_geom():
    K = scenes.K_DEFAULT
    depth_u16, _, _ = scenes.sphere_scene()
    p3d = cv2.rgbd.depthTo3d(depth_u16, K)
    resc = cv2.rgbd.rescaleDepth(depth_u16, cv2.CV_32F)
    dh = depth_u16.copy()
    dh[100:120, 200:240] = 0
    p3d_holes = cv2.rgbd.depthTo3d(dh, K)
    nrm = cv2.rgbd.RgbdNormals_create(
        480, 640, cv2.CV_32F, K, 5, cv2.rgbd.RgbdNormals_RGBD_NORMALS_METHOD_FALS
    )
    normals = nrm.apply(p3d)
    save(
        "geom",
        K=K,
        depth_u16=depth_u16,
        p3d=p3d,
        rescaled=resc,
        depth_holes=dh,
        p3d_holes=p3d_holes,
        normals_fals=normals,
    )


def gen_cg():
    cg = cv2.linemod_ColorGradient.create(10.0, 63, 55.0)
    out = {}
    _, gray, _ = scenes.sphere_scene()
    bgr = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
    out["sphere_in"] = bgr
    out["sphere_q"] = cg.process(bgr).quantize()
    rng = np.random.RandomState(1)
    noise = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    smooth = cv2.GaussianBlur(noise, (9, 9), 3)
    out["noise_in"] = smooth
    out["noise_q"] = cg.process(smooth).quantize()
    save("cg_quantize", **out)


def gen_lmn():
    """RgbdNormals LINEMOD method goldens (raw CV_16U input only —
    passing a points image segfaults, depth.hpp:112 / SURVEY appendix)."""
    K = scenes.K_DEFAULT
    est = cv2.rgbd.RgbdNormals_create(
        480, 640, cv2.CV_32F, K, 5,
        cv2.rgbd.RgbdNormals_RGBD_NORMALS_METHOD_LINEMOD,
    )
    out = {"K": K}
    yy, xx = np.mgrid[0:480, 0:640]
    cases = {}
    cases["sphere"] = scenes.sphere_scene()[0]
    cases["snowman"] = scenes.snowman_scene()[0]
    cases["rampxy"] = (1200 + 2 * xx + 3 * yy).astype(np.uint16)
    hole = np.full((480, 640), 1500, np.uint16)
    hole[200:260, 300:360] = 0
    cases["holes"] = hole
    for name, dep in cases.items():
        out[name + "_in"] = dep
        out[name + "_n"] = est.apply(dep)
    save("lmn_normals", **out)


def gen_sri():
    """RgbdNormals SRI method goldens (points-image input, like FALS) —
    quantifies PARITY deviation 4 with numbers."""
    K = scenes.K_DEFAULT
    est = cv2.rgbd.RgbdNormals_create(
        480, 640, cv2.CV_32F, K, 5,
        cv2.rgbd.RgbdNormals_RGBD_NORMALS_METHOD_SRI,
    )
    out = {"K": K}
    for name, dep in (("sphere", scenes.sphere_scene()[0]),
                      ("snowman", scenes.snowman_scene()[0])):
        p3d = cv2.rgbd.depthTo3d(dep, K)
        out[name + "_in"] = dep
        out[name + "_n"] = est.apply(p3d)
    save("sri_normals", **out)


def main():
    sections = sys.argv[1:] or ["dn", "geom", "cg", "lmn", "sri"]
    for s in sections:
        globals()["gen_" + s]()


if __name__ == "__main__":
    main()
