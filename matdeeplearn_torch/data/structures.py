"""Crystal/molecule structure representation and file readers.

Replaces the reference's dependency on ASE for structure IO
(reference: matdeeplearn/process/process.py:263-273 reads any ASE format;
in practice the shipped datasets are ASE-json files and ase.db sqlite
databases). We implement first-party readers for the formats the reference
datasets actually use — ASE-json, extended XYZ, VASP POSCAR and ase.db
sqlite — and fall back to the `ase` package when it is installed.

All readers are host-side, pure numpy. A copy of the reference package's
data/structures.py, kept so the PyTorch port imports nothing of that package.
"""

from __future__ import annotations

import json
import os
import sqlite3
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Structure:
    """A single atomic structure.

    Attributes:
      numbers:   (N,) int atomic numbers.
      positions: (N, 3) float64 Cartesian coordinates (Angstrom).
      cell:      (3, 3) float64 lattice row vectors; zeros if not periodic.
      pbc:       (3,) bool periodic boundary flags per axis.
      structure_id: identifier string (filename stem / db row id).
    """

    numbers: np.ndarray
    positions: np.ndarray
    cell: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    pbc: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=bool))
    structure_id: str = ""

    def __post_init__(self):
        self.numbers = np.asarray(self.numbers, dtype=np.int64)
        self.positions = np.asarray(self.positions, dtype=np.float64)
        self.cell = np.asarray(self.cell, dtype=np.float64)
        self.pbc = np.asarray(self.pbc, dtype=bool)

    def __len__(self) -> int:
        return len(self.numbers)

    @property
    def symbols(self) -> list[str]:
        return [CHEMICAL_SYMBOLS[z] for z in self.numbers]


# Chemical symbols indexed by atomic number (index 0 = placeholder "X").
CHEMICAL_SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]
SYMBOL_TO_NUMBER = {s: z for z, s in enumerate(CHEMICAL_SYMBOLS)}


def _decode_ase_ndarray(obj):
    """Decode ASE-json {"__ndarray__": [shape, dtype, flat_data]} objects."""
    if isinstance(obj, dict) and "__ndarray__" in obj:
        shape, dtype, data = obj["__ndarray__"]
        return np.array(data, dtype=dtype).reshape(shape)
    return obj


def read_ase_json(path: str, structure_id: str = "") -> Structure:
    """Read a single-image ASE json file (reference data format "json")."""
    with open(path) as f:
        doc = json.load(f)
    # ASE json: top-level keys "1", "2", ... per image (plus "ids"/"nextid").
    image_keys = [k for k in doc if k not in ("ids", "nextid") and isinstance(doc[k], dict)]
    key = sorted(image_keys, key=lambda k: int(k) if k.isdigit() else 0)[0]
    img = doc[key]

    numbers = _decode_ase_ndarray(img["numbers"])
    positions = _decode_ase_ndarray(img["positions"])
    pbc = _decode_ase_ndarray(img.get("pbc", np.zeros(3, dtype=bool)))
    cell_obj = img.get("cell", None)
    if isinstance(cell_obj, dict) and "array" in cell_obj:
        cell = _decode_ase_ndarray(cell_obj["array"])
    else:
        cell = _decode_ase_ndarray(cell_obj) if cell_obj is not None else np.zeros((3, 3))
    if cell is None or np.size(cell) == 0:
        cell = np.zeros((3, 3))
    return Structure(numbers, positions, cell, pbc, structure_id)


def read_xyz(path: str, structure_id: str = "") -> Structure:
    """Read (extended) XYZ. Supports Lattice="..." and pbc="T T T" in the comment."""
    with open(path) as f:
        lines = f.read().splitlines()
    natoms = int(lines[0].split()[0])
    comment = lines[1] if len(lines) > 1 else ""
    cell = np.zeros((3, 3))
    pbc = np.zeros(3, dtype=bool)
    # Parse key=value pairs (values possibly quoted) from the comment line.
    import re

    for m in re.finditer(r'(\w+)=(?:"([^"]*)"|(\S+))', comment):
        key = m.group(1).lower()
        val = m.group(2) if m.group(2) is not None else m.group(3)
        if key == "lattice":
            cell = np.array([float(x) for x in val.split()]).reshape(3, 3)
            pbc = np.ones(3, dtype=bool)
        elif key == "pbc":
            pbc = np.array([v in ("T", "True", "1") for v in val.split()])
    numbers, positions = [], []
    for ln in lines[2 : 2 + natoms]:
        parts = ln.split()
        sym = parts[0]
        numbers.append(int(sym) if sym.isdigit() else SYMBOL_TO_NUMBER[sym])
        positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return Structure(np.array(numbers), np.array(positions), cell, pbc, structure_id)


def read_poscar(path: str, structure_id: str = "") -> Structure:
    """Read VASP POSCAR/CONTCAR (vasp5 format with symbol line)."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()]
    scale = float(lines[1].split()[0])
    cell = np.array([[float(x) for x in lines[i].split()[:3]] for i in (2, 3, 4)])
    if scale < 0:  # negative scale = target volume
        vol = abs(np.linalg.det(cell))
        scale = (-scale / vol) ** (1.0 / 3.0)
    cell = cell * scale
    symbols = lines[5].split()
    counts = [int(x) for x in lines[6].split()]
    idx = 7
    if lines[idx].strip().lower().startswith("s"):  # selective dynamics
        idx += 1
    direct = lines[idx].strip().lower()[0] in ("d",)
    idx += 1
    numbers = []
    for s, c in zip(symbols, counts):
        numbers.extend([SYMBOL_TO_NUMBER[s]] * c)
    n = sum(counts)
    coords = np.array([[float(x) for x in lines[idx + i].split()[:3]] for i in range(n)])
    positions = coords @ cell if direct else coords * scale
    return Structure(np.array(numbers), positions, cell, np.ones(3, dtype=bool), structure_id)


def read_cif(path: str, structure_id: str = "") -> Structure:
    """Minimal CIF reader: cell parameters + atom_site fractional coordinates.

    Handles the common P1 case (as produced by pymatgen/ASE exports). Symmetry
    operations beyond P1 are not expanded — use `ase` for exotic CIFs.
    """
    import re

    with open(path) as f:
        text = f.read()

    def cell_param(name):
        m = re.search(rf"_cell_{name}\s+([-\d.eE()]+)", text)
        return float(re.sub(r"\(.*\)", "", m.group(1)))

    a, b, c = cell_param("length_a"), cell_param("length_b"), cell_param("length_c")
    alpha, beta, gamma = (
        np.radians(cell_param("angle_alpha")),
        np.radians(cell_param("angle_beta")),
        np.radians(cell_param("angle_gamma")),
    )
    # Standard crystallographic cell construction.
    va = np.array([a, 0, 0])
    vb = np.array([b * np.cos(gamma), b * np.sin(gamma), 0])
    cx = c * np.cos(beta)
    cy = c * (np.cos(alpha) - np.cos(beta) * np.cos(gamma)) / np.sin(gamma)
    cz = np.sqrt(max(c**2 - cx**2 - cy**2, 0.0))
    cell = np.vstack([va, vb, [cx, cy, cz]])

    # Find the atom_site loop.
    loops = re.findall(r"loop_\s*((?:\s*_\S+\n)+)((?:[^_l#][^\n]*\n?)+)", text)
    numbers, fracs = [], []
    for header, body in loops:
        cols = [h.strip() for h in header.strip().splitlines()]
        if "_atom_site_fract_x" not in cols:
            continue
        ix, iy, iz = (
            cols.index("_atom_site_fract_x"),
            cols.index("_atom_site_fract_y"),
            cols.index("_atom_site_fract_z"),
        )
        isym = (
            cols.index("_atom_site_type_symbol")
            if "_atom_site_type_symbol" in cols
            else cols.index("_atom_site_label")
        )
        for row in body.strip().splitlines():
            parts = row.split()
            if len(parts) < len(cols):
                continue
            sym = re.match(r"[A-Z][a-z]?", parts[isym]).group(0)
            numbers.append(SYMBOL_TO_NUMBER[sym])
            fracs.append(
                [float(re.sub(r"\(.*\)", "", parts[i])) for i in (ix, iy, iz)]
            )
        break
    positions = np.array(fracs) @ cell
    return Structure(np.array(numbers), positions, cell, np.ones(3, dtype=bool), structure_id)


def read_ase_db(path: str) -> list[Structure]:
    """Read all rows of an ase.db sqlite database (reference data format "db",
    process/process.py:244-254) without requiring ase."""
    con = sqlite3.connect(path)
    try:
        rows = con.execute(
            "SELECT id, numbers, positions, cell, pbc FROM systems ORDER BY id"
        ).fetchall()
    finally:
        con.close()
    out = []
    for rid, numbers, positions, cell, pbc in rows:
        num = np.frombuffer(numbers, dtype=np.int32)
        pos = np.frombuffer(positions, dtype=np.float64).reshape(-1, 3)
        cel = np.frombuffer(cell, dtype=np.float64).reshape(3, 3)
        # ase.db packs pbc as an integer bitmask.
        pbc_arr = np.array([bool(pbc & 1), bool(pbc & 2), bool(pbc & 4)])
        out.append(Structure(num.astype(np.int64), pos, cel, pbc_arr, str(rid)))
    return out


def read_ase_db_with_keys(path: str) -> list[tuple[Structure, dict]]:
    """Like read_ase_db but also returns each row's key-value pairs (the
    ase.db property store, e.g. C2DB 'workfunction'). Used by the dataset
    acquisition scripts (datasets/twod/get_c2db.py; reference:
    data/2D_data/read_db.py selects rows by 'workfunction')."""
    con = sqlite3.connect(path)
    try:
        rows = con.execute(
            "SELECT id, numbers, positions, cell, pbc, key_value_pairs "
            "FROM systems ORDER BY id"
        ).fetchall()
    finally:
        con.close()
    out = []
    for rid, numbers, positions, cell, pbc, kvp in rows:
        num = np.frombuffer(numbers, dtype=np.int32)
        pos = np.frombuffer(positions, dtype=np.float64).reshape(-1, 3)
        cel = np.frombuffer(cell, dtype=np.float64).reshape(3, 3)
        pbc_arr = np.array([bool(pbc & 1), bool(pbc & 2), bool(pbc & 4)])
        keys = json.loads(kvp) if kvp else {}
        out.append(
            (Structure(num.astype(np.int64), pos, cel, pbc_arr, str(rid)), keys)
        )
    return out


def write_ase_json(structure: Structure, path: str) -> None:
    """Write a Structure as an ASE-json file readable by read_ase_json (and
    by ase.io.read, so datasets we produce stay consumable by the reference
    framework too)."""

    def nd(arr, dtype):
        a = np.asarray(arr, dtype)
        return {"__ndarray__": [list(a.shape), str(a.dtype), a.ravel().tolist()]}

    obj = {
        "1": {
            "numbers": nd(structure.numbers, np.int64),
            "positions": nd(structure.positions, np.float64),
            "cell": nd(structure.cell, np.float64),
            "pbc": nd(structure.pbc, bool),
        },
        "ids": [1],
        "nextid": 2,
    }
    with open(path, "w") as f:
        json.dump(obj, f)


_READERS = {
    "json": read_ase_json,
    "xyz": read_xyz,
    "extxyz": read_xyz,
    "poscar": read_poscar,
    "vasp": read_poscar,
    "cif": read_cif,
}


def read_structure(path: str, fmt: str | None = None, structure_id: str = "") -> Structure:
    """Read a structure file; format inferred from extension if not given."""
    if fmt is None:
        fmt = os.path.splitext(path)[1].lstrip(".").lower() or "json"
    fmt = fmt.lower()
    if fmt in _READERS:
        return _READERS[fmt](path, structure_id)
    # Unknown format: fall back to ase if installed.
    try:
        import ase.io  # type: ignore

        atoms = ase.io.read(path)
        return Structure(
            atoms.get_atomic_numbers(),
            atoms.get_positions(),
            np.array(atoms.get_cell()),
            np.array(atoms.get_pbc()),
            structure_id,
        )
    except ImportError as e:
        raise ValueError(
            f"Unsupported structure format '{fmt}' and ase is not installed"
        ) from e


def mic_distance_matrix(structure: Structure) -> np.ndarray:
    """All-pairs distance matrix with the minimum image convention.

    Reproduces ase.Atoms.get_all_distances(mic=True)
    (reference: process/process.py:284). For periodic axes, pair deltas are
    wrapped into [-0.5, 0.5) fractional and the minimum over the 27 (3^3)
    neighboring-image shifts is taken — exact for cells whose Wigner-Seitz
    cell fits within one shell of images (all non-pathological cells).
    Non-periodic axes are never shifted.
    """
    pos = structure.positions
    n = len(pos)
    delta = pos[None, :, :] - pos[:, None, :]  # (n, n, 3) r_j - r_i
    if not structure.pbc.any() or abs(np.linalg.det(structure.cell)) < 1e-12:
        return np.linalg.norm(delta, axis=-1)

    cell = structure.cell
    inv = np.linalg.inv(cell)
    frac = delta @ inv
    # Wrap periodic axes to [-0.5, 0.5).
    wrap = np.where(structure.pbc, frac - np.round(frac), frac)
    shifts = np.array(
        np.meshgrid(*[[-1, 0, 1] if p else [0] for p in structure.pbc], indexing="ij")
    ).reshape(3, -1).T  # (S, 3)
    cand = (wrap[:, :, None, :] + shifts[None, None, :, :]) @ cell  # (n, n, S, 3)
    d = np.sqrt(np.sum(cand * cand, axis=-1))
    return d.min(axis=2)
