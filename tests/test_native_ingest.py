"""Native C++ ingest vs an independent pandas densify (skips when the
library cannot be built)."""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def native_lib(native_libs):
    from st_dadk_tpu.dataio.native import native_available
    if not native_available():
        pytest.skip("native lib not buildable")


def _pandas_reference(path):
    """Independent pandas densify (duplicating the fallback logic so the
    native path is checked against a second implementation)."""
    import pandas as pd
    df = pd.read_csv(path)
    df.columns = [c.strip().strip('"') for c in df.columns]
    mi = pd.MultiIndex.from_arrays([df["x"].to_numpy(), df["y"].to_numpy()])
    codes, uniques = mi.factorize()
    coords = np.asarray(uniques.to_frame().to_numpy(), dtype=np.float64)
    if "t" in df.columns:
        T = int(df["t"].max())
        t_idx = df["t"].to_numpy(np.int64) - 1
    else:
        T, t_idx = 1, np.zeros(len(df), np.int64)
    z = np.full((T, len(coords)), np.nan, np.float32)
    if "z" in df.columns:
        z[t_idx, codes] = df["z"].to_numpy(np.float32)
    return z, coords


def test_synthetic_csv(native_lib, tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    coords = rng.uniform(size=(50, 2)).round(6)
    for t in range(1, 8):
        for s in range(50):
            if rng.uniform() < 0.8:
                rows.append((coords[s, 0], coords[s, 1], t,
                             rng.normal()))
    csv = tmp_path / "toy.csv"
    with open(csv, "w") as f:
        f.write("x,y,t,z\n")
        for x, y, t, z in rows:
            f.write(f"{x},{y},{t},{z:.6f}\n")

    from st_dadk_tpu.dataio.native import load_csv_native
    z_n, c_n, n_rows = load_csv_native(csv)
    z_p, c_p = _pandas_reference(csv)
    assert n_rows == len(rows)
    assert z_n.shape == z_p.shape
    assert np.allclose(c_n, c_p, atol=0)          # identical site order
    both = np.isfinite(z_n) & np.isfinite(z_p)
    assert (np.isfinite(z_n) == np.isfinite(z_p)).all()
    assert np.allclose(z_n[both], z_p[both], atol=1e-6)


def test_quoted_header_and_id_column(native_lib, tmp_path):
    csv = tmp_path / "q.csv"
    with open(csv, "w") as f:
        f.write('"id_train","x","y","z"\n')
        f.write("1,0.5,0.25,1.5\n")
        f.write("2,0.75,0.1,-2.0\n")
    from st_dadk_tpu.dataio.native import load_csv_native
    z, coords, n = load_csv_native(csv)
    assert n == 2 and z.shape == (1, 2)
    assert np.allclose(coords, [[0.5, 0.25], [0.75, 0.1]])
    assert np.allclose(z[0], [1.5, -2.0])


def test_float64_distinct_sites(native_lib, tmp_path):
    """Coordinates distinct only beyond float32 precision must stay distinct
    sites, and site_to_idx keys must be the CSV's exact float64 values
    (regression: float32 bit-pattern hashing merged them)."""
    x0 = 0.123456789012345
    x1 = x0 + 1e-12                 # same float32, different float64
    assert np.float32(x0) == np.float32(x1) and x0 != x1
    csv = tmp_path / "prec.csv"
    with open(csv, "w") as f:
        f.write("x,y,z\n")
        f.write(f"{x0!r},0.5,1.0\n")
        f.write(f"{x1!r},0.5,2.0\n")
    from st_dadk_tpu.dataio.native import load_csv_native
    z, coords, n = load_csv_native(csv)
    assert n == 2
    assert z.shape == (1, 2), "float64-distinct sites were merged"
    assert coords.dtype == np.float64
    assert coords[0, 0] == x0 and coords[1, 0] == x1

    # the full loader keeps exact doubles as site_to_idx keys
    from st_dadk_tpu.dataio.kaust import load_kaust_csv_single
    _, _, meta = load_kaust_csv_single(csv, normalize=False, verbose=False)
    assert (x0, 0.5) in meta["site_to_idx"]
    assert (x1, 0.5) in meta["site_to_idx"]


def test_trailing_empty_field(native_lib, tmp_path):
    """A row ending in a trailing comma (empty z) must yield NaN for THAT
    row and leave the next row intact (regression: strtod treated the
    newline as leading whitespace and parsed the next line's x as this
    row's z, then swallowed the whole next row)."""
    csv = tmp_path / "trail.csv"
    with open(csv, "w") as f:
        f.write("x,y,t,z\n")
        f.write("0.1,0.2,3,\n")       # empty z at end-of-row
        f.write("0.5,0.6,4,1.25\n")
    from st_dadk_tpu.dataio.native import load_csv_native
    z, coords, n = load_csv_native(csv)
    assert n == 2, "row after the trailing-comma row was dropped"
    assert z.shape == (4, 2)
    assert np.isnan(z[2, 0]), "empty trailing field must be NaN"
    assert z[3, 1] == np.float32(1.25)
    assert np.allclose(coords, [[0.1, 0.2], [0.5, 0.6]])


def test_many_columns(native_lib, tmp_path):
    """Columns are bounded by the header, not a hard cap (regression: a
    16-column cap silently made z all-NaN when z sat past column 16)."""
    extras = [f"c{i}" for i in range(20)]
    csv = tmp_path / "wide.csv"
    with open(csv, "w") as f:
        f.write(",".join(extras) + ",x,y,z\n")
        f.write(",".join(str(i) for i in range(20)) + ",0.5,0.25,7.0\n")
        f.write(",".join(str(i) for i in range(20)) + ",0.75,0.1,-3.0\n")
    from st_dadk_tpu.dataio.native import load_csv_native
    z, coords, n = load_csv_native(csv)
    assert n == 2 and z.shape == (1, 2)
    assert np.allclose(coords, [[0.5, 0.25], [0.75, 0.1]])
    assert np.allclose(z[0], [7.0, -3.0])


def test_real_file_parity(native_lib, ref_data_root):
    path = ref_data_root / "2a" / "2a_8.csv"
    from st_dadk_tpu.dataio.native import load_csv_native
    z_n, c_n, n_rows = load_csv_native(path)
    z_p, c_p = _pandas_reference(path)
    assert n_rows == 100000
    assert z_n.shape == z_p.shape == (100, 1000)
    assert np.allclose(c_n, c_p, atol=0)
    assert np.allclose(z_n, z_p, atol=1e-6, equal_nan=True)
