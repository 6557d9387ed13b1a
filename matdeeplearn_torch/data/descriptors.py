"""Whole-structure descriptors: Coulomb/Sine matrix eigenspectra and SOAP.

The port's own copy of the reference package's data/descriptors.py
(numpy only, the same functions and the same float64 arithmetic), the
first-party replacement for the reference's dscribe dependency
(matdeeplearn/process/process.py:430-494). Host-side: descriptors are
computed once during preprocessing and are not on the training path.

  * `coulomb_matrix` / `sine_matrix` + `eigenspectrum`: the reference's
    CoulombMatrix/SineMatrix with permutation="eigenspectrum"
    (process.py:468-487): eigenvalues sorted by |λ| descending, zero-padded
    to the dataset's largest atom count (`sm_features`).
  * `soap_features`: the inner-averaged SOAP power spectrum
    (process.py:437-466, avg="inner", rbf="gto"): the Gaussian-smeared
    neighbor density is expanded exactly onto a Löwdin-orthonormalized GTO
    radial basis × real spherical harmonics (the exact expansion of a
    Gaussian at distance R uses the scaled modified spherical Bessel
    function ĩ_l(rR/σ²)e^{-(r-R)²/2σ²}), coefficients are averaged over
    centers ("inner"), and the rotation-invariant power spectrum
    p[(Z1≤Z2), n, l] = Σ_m c^{Z1}_{nlm} c^{Z2}_{nlm} is returned. From 256
    structures it runs in a spawn process pool of MDL_DESCRIPTOR_WORKERS
    workers (default: every core).
"""

from __future__ import annotations

import numpy as np

from matdeeplearn_torch.data.structures import Structure, mic_distance_matrix


# --------------------------------------------------------------- CM / SM


def coulomb_matrix(structure: Structure, n_max: int) -> np.ndarray:
    """Coulomb matrix, zero-padded to (n_max, n_max).

    M_ii = 0.5 Z_i^2.4, M_ij = Z_i Z_j / |r_i - r_j|.
    """
    z = structure.numbers.astype(np.float64)
    n = len(z)
    d = mic_distance_matrix(structure)
    with np.errstate(divide="ignore"):
        m = np.outer(z, z) / np.where(d > 0, d, np.inf)
    np.fill_diagonal(m, 0.5 * z ** 2.4)
    out = np.zeros((n_max, n_max))
    out[:n, :n] = m
    return out


def sine_matrix(structure: Structure, n_max: int) -> np.ndarray:
    """Sine matrix (periodic analogue of the Coulomb matrix), padded.

    M_ij = Z_i Z_j / φ(r_i, r_j) with
    φ = |B · sin²(π (r_i - r_j) B⁻¹)| — invariant under lattice
    translations by construction (the fractional delta enters through sin²).
    """
    z = structure.numbers.astype(np.float64)
    n = len(z)
    cell = structure.cell
    inv = np.linalg.inv(cell)
    delta = structure.positions[:, None, :] - structure.positions[None, :, :]
    frac = delta @ inv                      # (n, n, 3)
    v = np.sin(np.pi * frac) ** 2           # lattice-translation invariant
    phi = np.linalg.norm(v @ cell, axis=-1)  # (n, n)
    with np.errstate(divide="ignore"):
        m = np.outer(z, z) / np.where(phi > 0, phi, np.inf)
    np.fill_diagonal(m, 0.5 * z ** 2.4)
    out = np.zeros((n_max, n_max))
    out[:n, :n] = m
    return out


def eigenspectrum(matrix: np.ndarray) -> np.ndarray:
    """Eigenvalues of a symmetric matrix sorted by |λ| descending
    (dscribe's permutation="eigenspectrum" convention)."""
    ev = np.linalg.eigvalsh(matrix)
    return ev[np.argsort(-np.abs(ev), kind="stable")]


def sm_features(structures: list[Structure], n_atoms_max: int) -> np.ndarray:
    """Eigenspectrum SM features, (G, n_atoms_max).

    Sine matrix for periodic structures, Coulomb matrix for clusters
    (the sine matrix is undefined without a cell; dscribe's SineMatrix
    requires periodicity, reference process.py:481-487).
    """
    out = np.zeros((len(structures), n_atoms_max), np.float64)
    for i, s in enumerate(structures):
        periodic = s.pbc.any() and abs(np.linalg.det(s.cell)) > 1e-12
        m = sine_matrix(s, n_atoms_max) if periodic else coulomb_matrix(s, n_atoms_max)
        out[i] = eigenspectrum(m)
    return out


# ------------------------------------------------------------------- SOAP


def _real_sph_harm(lmax: int, unit: np.ndarray) -> np.ndarray:
    """Real spherical harmonics Y_lm for unit vectors.

    unit: (P, 3) unit vectors. Returns (P, (lmax+1)^2) with the standard
    flat (l, m) layout: index l² + (m + l), m ∈ [-l, l].
    Associated Legendre via stable upward-in-l recurrences.
    """
    x, y, zc = unit[:, 0], unit[:, 1], unit[:, 2]
    ct = np.clip(zc, -1.0, 1.0)                       # cosθ
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))      # sinθ
    phi = np.arctan2(y, x)

    p = len(unit)
    # P_l^m(cosθ) for 0 <= m <= l <= lmax (Condon-Shortley phase).
    plm = np.zeros((lmax + 1, lmax + 1, p))
    plm[0, 0] = 1.0
    for m in range(1, lmax + 1):
        plm[m, m] = -(2 * m - 1) * st * plm[m - 1, m - 1]
    for m in range(lmax):
        plm[m + 1, m] = (2 * m + 1) * ct * plm[m, m]
    for m in range(lmax + 1):
        for l in range(m + 2, lmax + 1):
            plm[l, m] = (
                (2 * l - 1) * ct * plm[l - 1, m] - (l + m - 1) * plm[l - 2, m]
            ) / (l - m)

    from math import factorial

    out = np.zeros((p, (lmax + 1) ** 2))
    for l in range(lmax + 1):
        for m in range(l + 1):
            nlm = np.sqrt(
                (2 * l + 1) / (4 * np.pi) * factorial(l - m) / factorial(l + m)
            )
            if m == 0:
                out[:, l * l + l] = nlm * plm[l, 0]
            else:
                base = np.sqrt(2.0) * nlm * plm[l, m]
                out[:, l * l + l + m] = base * np.cos(m * phi)
                out[:, l * l + l - m] = base * np.sin(m * phi)
    return out


def _scaled_mod_sph_bessel(lmax: int, x: np.ndarray) -> np.ndarray:
    """ĩ_l(x) = e^{-x} i_l(x) for l = 0..lmax, via downward (Miller)
    recurrence — stable for all x ≥ 0. Returns (lmax+1, len(x))."""
    x = np.asarray(x, np.float64)
    out = np.zeros((lmax + 1, len(x)))
    small = x < 1e-6
    # Series at x→0: i_l(x) ≈ x^l / (2l+1)!!, e^{-x} ≈ 1.
    dfact = 1.0
    for l in range(lmax + 1):
        out[l, small] = (x[small] ** l) / dfact
        dfact *= 2 * l + 3

    xs = x[~small]
    if len(xs):
        nstart = lmax + 16
        bp = np.zeros_like(xs)            # b_{l+1}
        bc = np.full_like(xs, 1e-280)     # b_l, seeded at l = nstart
        cols = np.zeros((lmax + 1, len(xs)))
        for l in range(nstart, -1, -1):
            if l <= lmax:
                cols[l] = bc
            if l == 0:
                break
            bm = bp + (2 * l + 1) / xs * bc   # b_{l-1}
            bp, bc = bc, bm
            # Rescale any column about to overflow (uniformly, so the
            # final per-x normalization by ĩ_0 stays exact).
            big = np.abs(bc) > 1e250
            if big.any():
                scale = np.where(big, 1e-250, 1.0)
                bp *= scale
                bc *= scale
                cols *= scale[None, :]
        # Normalize with the exact ĩ_0 = (1 - e^{-2x}) / (2x).
        i0 = (1.0 - np.exp(-2.0 * xs)) / (2.0 * xs)
        out[:, ~small] = cols * (i0 / cols[0])
    return out


def _gto_radial_basis(nmax: int, rcut: float, grid: np.ndarray) -> np.ndarray:
    """Löwdin-orthonormalized GTO radial basis on a quadrature grid.

    Raw functions φ_n(r) = exp(-α_n r²) with α_n set so φ_n decays to 1e-3
    at r_n = rcut·(n+1)/nmax (dscribe's gto convention). Returns (nmax, R)
    orthonormal w.r.t. ∫ g_n g_m r² dr = δ_nm on the grid.
    """
    rn = rcut * (np.arange(1, nmax + 1) / nmax)
    alphas = -np.log(1e-3) / rn ** 2
    phi = np.exp(-alphas[:, None] * grid[None, :] ** 2)  # (nmax, R)
    w = np.gradient(grid) * grid ** 2                     # quadrature weights
    s = (phi * w[None, :]) @ phi.T                        # overlap
    evals, evecs = np.linalg.eigh(s)
    s_inv_half = evecs @ np.diag(1.0 / np.sqrt(np.maximum(evals, 1e-12))) @ evecs.T
    return s_inv_half @ phi


def _neighbor_images(structure: Structure, rcut: float):
    """All neighbor positions (with periodic images within rcut) and their
    species, relative to nothing in particular — absolute Cartesian coords."""
    pos = structure.positions
    z = structure.numbers
    periodic = structure.pbc.any() and abs(np.linalg.det(structure.cell)) > 1e-12
    if not periodic:
        return pos, z
    cell = structure.cell
    # Repeats per axis: rcut / perpendicular cell height.
    vol = abs(np.linalg.det(cell))
    reps = []
    for a in range(3):
        if structure.pbc[a]:
            cross = np.cross(cell[(a + 1) % 3], cell[(a + 2) % 3])
            height = vol / np.linalg.norm(cross)
            reps.append(int(np.ceil(rcut / height)))
        else:
            reps.append(0)
    shifts = np.array(
        np.meshgrid(*[range(-r, r + 1) for r in reps], indexing="ij")
    ).reshape(3, -1).T  # (S, 3)
    img_pos = (pos[None, :, :] + (shifts @ cell)[:, None, :]).reshape(-1, 3)
    img_z = np.tile(z, len(shifts))
    return img_pos, img_z


def _soap_one(
    s: Structure,
    sp_index: dict,
    nsp: int,
    pairs: list,
    gnl: np.ndarray,
    grid: np.ndarray,
    w: np.ndarray,
    rcut: float,
    nmax: int,
    lmax: int,
    sigma: float,
    pair_chunk: int = 8192,
) -> np.ndarray:
    """SOAP vector for one structure, vectorized over ALL (center, image)
    pairs at once. Exact rewrite of a per-center loop: inner averaging
    sums coefficient contributions over every center before the power
    spectrum, so center identity never matters — flattening the
    (center, image) pairs changes only the Python-loop count (~n_atoms x
    fewer iterations), not the math (held to the brute-force
    integration oracle of tests/test_soap_oracle.py)."""
    nl = lmax + 1
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    img_pos, img_z = _neighbor_images(s, rcut)
    img_sp = np.fromiter(
        (sp_index.get(int(t), -1) for t in img_z), np.int64, len(img_z)
    )

    rel = img_pos[None, :, :] - s.positions[:, None, :]      # (C, I, 3)
    dist = np.linalg.norm(rel, axis=2)                       # (C, I)
    cidx, iidx = np.nonzero((dist <= rcut) & (img_sp >= 0)[None, :])
    dd = dist[cidx, iidx]
    un = rel[cidx, iidx] / np.maximum(dd, 1e-12)[:, None]
    spv = img_sp[iidx]

    # lm -> l map: broadcasts the radial integral onto the (L+1)^2 lm axis
    lmap = np.repeat(np.arange(nl), 2 * np.arange(nl) + 1)

    c = np.zeros((nsp, nmax, nl * nl))
    for lo in range(0, len(dd), pair_chunk):
        sl = slice(lo, lo + pair_chunk)
        dds, uns, sps = dd[sl], un[sl], spv[sl]
        ylm = _real_sph_harm(lmax, uns)                      # (P, (L+1)^2)
        # Exact radial projection of a Gaussian at distance R:
        # I[n, l, p] = 4pi * int g_n(r) e^{-(r-R)^2/2s^2} i_l(rR/s^2) r^2 dr
        expo = np.exp(-inv2s2 * (grid[None, :] - dds[:, None]) ** 2)
        il = _scaled_mod_sph_bessel(
            lmax, (grid[None, :] * dds[:, None] * 2 * inv2s2).ravel()
        ).reshape(nl, len(dds), len(grid))                   # (L+1, P, R)
        integ = 4 * np.pi * np.einsum(
            "nr,pr,lpr,r->pnl", gnl, expo, il, w, optimize=True
        )                                                    # (P, nmax, L+1)
        contrib = integ[:, :, lmap] * ylm[:, None, :]        # (P, nmax, (L+1)^2)
        np.add.at(c, sps, contrib)
    c /= max(len(s), 1)

    # Power spectrum: p[(a<=b), n, l] = sum_m c[a,n,lm] c[b,n,lm].
    vec = np.zeros((len(pairs), nmax, nl))
    for pi, (a, b) in enumerate(pairs):
        for l in range(nl):
            sll = slice(l * l, (l + 1) * (l + 1))
            vec[pi, :, l] = np.einsum("nm,nm->n", c[a, :, sll], c[b, :, sll])
    return vec.ravel()


def _soap_chunk(args) -> np.ndarray:
    """Worker: SOAP vectors for a chunk of structures (top-level for spawn
    picklability)."""
    structures, kw = args
    return np.stack([_soap_one(s, **kw) for s in structures])


def soap_features(
    structures: list[Structure],
    species: list[int],
    rcut: float,
    nmax: int,
    lmax: int,
    sigma: float,
    n_workers: int | None = None,
) -> np.ndarray:
    """Inner-averaged SOAP power spectrum for each structure.

    Returns (G, P*nmax*(lmax+1)) with P = S(S+1)/2 species pairs
    (Z1 <= Z2, ascending), layout [(pair, n, l)].

    Host-parallel: structures are independent, so chunks run in
    `n_workers` processes (default: all cores, or MDL_DESCRIPTOR_WORKERS).
    Per structure the math is vectorized over every (center, image)
    pair."""
    import os

    species = sorted(set(int(s) for s in species))
    nsp = len(species)
    sp_index = {zz: i for i, zz in enumerate(species)}
    pairs = [(a, b) for a in range(nsp) for b in range(a, nsp)]
    nl = lmax + 1

    grid = np.linspace(1e-4, rcut + 4 * sigma, 256)
    gnl = _gto_radial_basis(nmax, rcut, grid)              # (nmax, R)
    w = np.gradient(grid) * grid ** 2                      # quadrature weights

    kw = dict(sp_index=sp_index, nsp=nsp, pairs=pairs, gnl=gnl, grid=grid,
              w=w, rcut=rcut, nmax=nmax, lmax=lmax, sigma=sigma)
    if n_workers is None:
        n_workers = int(
            os.environ.get("MDL_DESCRIPTOR_WORKERS", os.cpu_count() or 1)
        )
    n_workers = max(1, min(n_workers, len(structures)))

    # Pool spawn costs ~seconds; the vectorized math is ~1 ms/structure
    # for small clusters, so workers only pay off on large corpora.
    if n_workers == 1 or len(structures) < 256:
        return _soap_chunk((structures, kw))

    import concurrent.futures as cf
    import multiprocessing as mp

    chunks = np.array_split(np.arange(len(structures)), n_workers * 4)
    chunks = [c for c in chunks if len(c)]
    try:
        with cf.ProcessPoolExecutor(
            max_workers=n_workers, mp_context=mp.get_context("spawn")
        ) as pool:
            parts = list(pool.map(
                _soap_chunk,
                [([structures[i] for i in c], kw) for c in chunks],
            ))
    except Exception:  # worker-pool failure: fall back to in-process
        return _soap_chunk((structures, kw))
    return np.concatenate(parts)
