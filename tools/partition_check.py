#!/usr/bin/env python
"""VCM full-technique partition-unity checker.

For a FIXED diffuse path x0(camera) -> x1 -> x2 -> x3(light), compute the
MIS weight that each technique in the production VCM code would assign to
this path — naive (s=0), NEE (s=1), connection (s=2), light-trace splat
(t=1), merge at x1, merge at x2 — by replaying the exact d_vcm/d_vc/d_vm
recursions and weight expressions from models/vcm.py + models/mis.py, in
scalar numpy. Then compare against ground-truth balance-heuristic weights
p_i / sum(p_j) computed directly from the technique pdfs.

If the code weights are a consistent partition they sum to 1 and the VCM
estimator conserves energy; a systematic shortfall here IS the measured
0.6x brightness deficit. The per-technique ratio (code weight / truth
weight) pinpoints the inconsistent expression.

Run: python tools/partition_check.py
"""

import numpy as np

PI = np.pi


def nrm(v):
    return v / np.linalg.norm(v)


def main():
    # geometry: floor y=-1 (n=+y), back wall z=-2 (n=+z),
    # ceiling light at y=+1 (n=-y)
    x0 = np.array([0.0, 0.0, 1.0])     # camera
    x1 = np.array([0.2, -1.0, -0.7])   # floor
    x2 = np.array([0.5, 0.1, -2.0])    # wall
    x3 = np.array([0.1, 1.0, -1.0])    # light
    n1 = np.array([0.0, 1.0, 0.0])
    n2 = np.array([0.0, 0.0, 1.0])
    n3 = np.array([0.0, -1.0, 0.0])    # light normal (faces down)
    cam_fwd = nrm(np.array([0.0, -0.35, -1.0]))

    plane_area = 4.0 * (2.0 / 1.5)     # arbitrary: 4*aspect*fov_scale^2
    pdf0 = 1.0 / (1 * 0.25)            # light pick area pdf (num=1, A=0.25)
    eta = 0.9                          # N * pi * r^2, production-scale O(1)

    def cos_at(n, a, b):
        return abs(np.dot(n, nrm(b - a)))

    def d2(a, b):
        return np.dot(b - a, b - a)

    # area pdfs of each generating step
    def cam_pdf_area(x):
        co = abs(np.dot(cam_fwd, nrm(x - x0)))
        pdf_sa = 1.0 / (plane_area * co ** 3)
        return pdf_sa * cos_at(n1, x, x0) / d2(x0, x)

    def diff_pdf_sa(nfrom, a, b):
        # cosine-hemisphere pdf of scattering a->b about nfrom
        return cos_at(nfrom, a, b) / PI

    def diff_pdf_area(nfrom, nto, a, b):
        return diff_pdf_sa(nfrom, a, b) * cos_at(nto, b, a) / d2(a, b)

    def emit_pdf_area(xto, nto):
        return (cos_at(n3, x3, xto) / PI) * cos_at(nto, xto, x3) / d2(x3, xto)

    # ---- ground-truth technique pdfs (area-product measure over x1,x2,x3)
    Pc = cam_pdf_area(x1)
    Pd12 = diff_pdf_area(n1, n2, x1, x2)
    Pd23 = diff_pdf_area(n2, n3, x2, x3)
    Pe32 = emit_pdf_area(x2, n2)
    Pd21 = diff_pdf_area(n2, n1, x2, x1)

    p = {
        "naive": Pc * Pd12 * Pd23,
        "nee": Pc * Pd12 * pdf0,
        "conn": Pc * (pdf0 * Pe32),
        "splat": pdf0 * Pe32 * Pd21 * Pc,   # numLightSample=1 model
        "merge1": eta * (pdf0 * Pe32 * Pd21) * Pc,
        "merge2": eta * (pdf0 * Pe32) * (Pc * Pd12),
    }
    tot = sum(p.values())
    truth = {k: v / tot for k, v in p.items()}

    # ---- replay the code's recursions -------------------------------
    # EYE walk: x0 -> x1 -> x2 -> x3  (models/vcm.py body + mis.advance)
    def advance(prev, first, pfa, g, rev_prev, eta):
        # prev = (d_vcm, d_vc, d_vm); returns current values
        if first:
            return (1.0 / pfa, first[0], first[1])
        d_vcm = 1.0 / pfa
        d_vc = (g / pfa) * (eta + prev[0] + rev_prev * prev[1])
        d_vm = (g / pfa) * (1.0 + prev[0] / eta + rev_prev * prev[2])
        return (d_vcm, d_vc, d_vm)

    # eye depth 0 (vertex x1)
    e1 = advance(None, (0.0, 0.0), cam_pdf_area(x1), None, None, eta)
    rev_e1 = diff_pdf_sa(n1, x1, x0)   # scatter x1 -> back toward camera
    # eye depth 1 (vertex x2)
    g12 = cos_at(n1, x1, x2) / d2(x1, x2)
    e2 = advance(e1, None, Pd12, g12, rev_e1, eta)
    rev_e2 = diff_pdf_sa(n2, x2, x1)
    # eye depth 2 (vertex x3) — for naive
    g23 = cos_at(n2, x2, x3) / d2(x2, x3)
    e3 = advance(e2, None, Pd23, g23, rev_e2, eta)

    # LIGHT walk: x3 -> x2 -> x1 (paths.start_light_walk + random_walk)
    l1 = (1.0 / Pe32,
          (1.0 / pdf0) * (cos_at(n3, x3, x2) / d2(x3, x2)) / Pe32,
          (1.0 / pdf0) * (cos_at(n3, x3, x2) / d2(x3, x2)) / Pe32 / eta)
    rev_l1 = diff_pdf_sa(n2, x2, x3)
    g21 = cos_at(n2, x2, x1) / d2(x2, x1)
    l2 = advance(l1, None, Pd21, g21, rev_l1, eta)
    rev_l2 = diff_pdf_sa(n1, x1, x2)

    code = {}

    # naive at x3 (vcm.py s=0): prev not delta
    pdf_connect = pdf0
    cos_l = cos_at(n3, x3, x2)
    w_eye = pdf_connect * e3[0] + pdf_connect * (cos_l / PI) * e3[1]
    code["naive"] = 1.0 / (1.0 + w_eye)

    # NEE at x2 (vcm.py s=1): eye vertex x2, light sample x3
    pdf_bsdf_area = diff_pdf_area(n2, n3, x2, x3)
    ratio = pdf_bsdf_area / pdf_connect
    w_light = ratio * ratio            # reference quirk (squared)
    pdf_curr_rev_area = emit_pdf_area(x2, n2)
    pdf_prev_rev_sa = diff_pdf_sa(n2, x2, x1)
    w_eye = pdf_curr_rev_area * (eta + e2[0] + pdf_prev_rev_sa * e2[1])
    code["nee"] = 1.0 / (1.0 + w_light + w_eye)

    # connection eye x1 <-> light x2 (vcm.py s>=2)
    pdf_eye_rev_area = diff_pdf_area(n2, n1, x2, x1)    # light vtx -> eye vtx
    pdf_bef_eye_rev = diff_pdf_sa(n1, x1, x0)
    pdf_light_rev_area = diff_pdf_area(n1, n2, x1, x2)  # eye vtx -> light vtx
    pdf_bef_light_rev = diff_pdf_sa(n2, x2, x3)
    w_eye = pdf_eye_rev_area * (eta + e1[0] + pdf_bef_eye_rev * e1[1])
    w_light = pdf_light_rev_area * (eta + l1[0] + pdf_bef_light_rev * l1[1])
    code["conn"] = 1.0 / (1.0 + w_eye + w_light)

    # splat at x1 (vcm_light_splat): light vertex x1 (= l2) -> camera
    pdf_curr_rev_area = cam_pdf_area(x1)
    pdf_rev_sa = diff_pdf_sa(n1, x1, x2)  # x1 scatters back toward x2
    w_light = pdf_curr_rev_area * (eta + l2[0] + pdf_rev_sa * l2[1])
    code["splat"] = 1.0 / (1.0 + w_light)

    # merge at x1: eye vertex x1 (e1), photon = light-walk depth2 (l2)
    pdf_eye_rev = diff_pdf_sa(n1, x1, x0)   # toward eye prev (camera)
    pdf_light_rev = diff_pdf_sa(n1, x1, x2)  # toward photon prev (x2)
    w_eye = e1[0] / eta + pdf_eye_rev * e1[2]
    w_light = l2[0] / eta + pdf_light_rev * l2[2]
    code["merge1"] = 1.0 / (1.0 + w_eye + w_light)

    # merge at x2: eye vertex x2 (e2), photon = light-walk depth1 (l1)
    pdf_eye_rev = diff_pdf_sa(n2, x2, x1)
    pdf_light_rev = diff_pdf_sa(n2, x2, x3)
    w_eye = e2[0] / eta + pdf_eye_rev * e2[2]
    w_light = l1[0] / eta + pdf_light_rev * l1[2]
    code["merge2"] = 1.0 / (1.0 + w_eye + w_light)

    print(f"{'technique':<8} {'code w':>10} {'truth w':>10} {'ratio':>8}")
    for k in p:
        print(f"{k:<8} {code[k]:>10.5f} {truth[k]:>10.5f} "
              f"{code[k]/truth[k]:>8.4f}")
    print(f"{'SUM':<8} {sum(code.values()):>10.5f} "
          f"{sum(truth.values()):>10.5f}")


if __name__ == "__main__":
    main()
