"""Data splitter CLI: train/val/test splits that keep places apart.

Counterpart of ``instageo_tpu/data/data_splitter.py``, with the same flags
(on ``argparse``, ``data/flags.py``), strategy cascade and output files,
over records (``data/table.py``) and without pandas or scikit-learn::

    python -m instageo_tpu_torch.data.data_splitter \\
        --input_file=hls_dataset.csv --output_dir=splits --n_clusters=20

The cascade: KMeans geo-clusters of the MGRS tile centres (the default),
then MGRS proximity groups (haversine connectivity), then year groups,
then a random split; the test set takes the most recent groups.

scikit-learn's three parts are written here in numpy, draw for draw:
``train_test_split`` (``RandomState(seed).permutation``, the test count
rounded up), ``StandardScaler`` (population variance by the corrected
two-pass sum, scale 1 for a constant feature) and ``KMeans(n_init=10)``
(greedy k-means++ with 2 + ⌊ln k⌋ local trials on the centred data, the
tolerance 1e-4 × the mean feature variance, Lloyd's iterations with its
stop rules, empty-cluster relocation and final E-step, every draw from one
``RandomState(random_state)``, the best inertia kept). The group shuffle is
Python's ``random``, seeded with ``random_state``, as there.
"""

from __future__ import annotations

import logging
import math
import os
import random
import re
import sys
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from instageo_tpu_torch.data import flags as _flags
from instageo_tpu_torch.data.crs import haversine_km, mgrs_to_latlon
from instageo_tpu_torch.data.table import Record, read_csv, write_csv

SPLITTER_FLAGS = (
    _flags.Flag("random_state", "integer", 42, "Random seed", lower=0),
    _flags.Flag("val_ratio", "float", 0.20, "Validation fraction"),
    _flags.Flag("test_ratio", "float", 0.20, "Test fraction"),
    _flags.Flag("visualize", "bool", True, "Generate split visualizations"),
    _flags.Flag("include_val", "bool", True, "Include a validation split"),
    _flags.Flag("include_test", "bool", True, "Include a test split"),
    _flags.Flag("allow_group_overlap", "bool", True, "Allow groups to span multiple splits"),
    _flags.Flag("distance_threshold", "float", 400.0, "Km threshold for MGRS proximity groups"),
    _flags.Flag("input_file", "string", "", "Path to input CSV file"),
    _flags.Flag("output_dir", "string", "", "Base directory for output files"),
    _flags.Flag("n_clusters", "integer", 20, "Number of KMeans clusters"),
    _flags.Flag("use_kmeans", "bool", True, "Use KMeans clustering first"),
)

# Columns the splitter adds to a record; none reaches the output files.
_WORK_COLUMNS = ("mgrs_tile", "year", "mask", "group_id", "cluster", "lat", "lon")

_mgrs_coord_cache: Dict[str, Optional[Tuple[float, float]]] = {}


def _tile_center(tile: Optional[str]) -> Optional[Tuple[float, float]]:
    if tile not in _mgrs_coord_cache:
        try:
            _mgrs_coord_cache[tile] = mgrs_to_latlon(tile)
        except Exception:  # an unresolvable tile has no centre
            _mgrs_coord_cache[tile] = None
    return _mgrs_coord_cache[tile]


def extract_mgrs_tile(file_path: str) -> Optional[str]:
    """The first MGRS-looking token (1-2 digits, 3 letters) of the file name."""
    match = re.search(r"(\d{1,2}[a-zA-Z]{3})", os.path.basename(file_path))
    return match.group(1).upper() if match else None


def extract_year(file_path: str) -> Optional[int]:
    """The first plausible 4-digit year of the file name."""
    matches = re.findall(r"(19[0-9]{2}|20[0-9]{2})", os.path.basename(file_path))
    return int(matches[0]) if matches else None


def _connected_components(tiles: List[str], distance_threshold: float) -> List[Set[str]]:
    """Components of the tiles under a km threshold: a breadth-first search
    with a lat/lon box prefilter before the exact haversine; tiles without
    a centre are components of their own."""
    n = len(tiles)
    lat = np.full(n, np.nan)
    lon = np.full(n, np.nan)
    for i, t in enumerate(tiles):
        c = _tile_center(t)
        if c:
            lat[i], lon[i] = c
    resolvable = ~np.isnan(lat)
    visited = ~resolvable
    groups: List[Set[str]] = [{tiles[i]} for i in np.nonzero(~resolvable)[0]]

    dlat_max = distance_threshold / 111.0 * 1.05
    for start in range(n):
        if visited[start]:
            continue
        visited[start] = True
        comp = [start]
        frontier = [start]
        while frontier:
            i = frontier.pop()
            cos_lat = max(float(np.cos(np.radians(lat[i]))), 1e-6)
            dlon_max = distance_threshold / (111.0 * cos_lat) * 1.05
            dlon = np.abs((lon - lon[i] + 180.0) % 360.0 - 180.0)
            cand = (~visited) & (np.abs(lat - lat[i]) <= dlat_max) & (dlon <= dlon_max)
            idxs = np.nonzero(cand)[0]
            if idxs.size == 0:
                continue
            d = haversine_km(lat[i], lon[i], lat[idxs], lon[idxs])
            near = idxs[d <= distance_threshold]
            visited[near] = True
            comp.extend(near.tolist())
            frontier.extend(near.tolist())
        groups.append({tiles[j] for j in comp})
    return groups


def find_connected_tiles(tile: str, remaining: Set[str], distance_threshold: float
                         ) -> Set[str]:
    """All tiles transitively within ``distance_threshold`` km of ``tile``;
    the tiles of that component are removed from ``remaining``."""
    pool = [tile] + [t for t in remaining if t != tile]
    for comp in _connected_components(pool, distance_threshold):
        if tile in comp:
            remaining.difference_update(comp)
            return comp
    return {tile}


def group_close_mgrs_tiles(mgrs_tiles: List[str],
                           distance_threshold: float = 400.0) -> List[Set[str]]:
    """Connected components of the distinct tiles under the km threshold."""
    return _connected_components(list(dict.fromkeys(mgrs_tiles)), distance_threshold)


# ---------------------------------------------------------------------------
# scikit-learn's train_test_split, StandardScaler and KMeans, in numpy
# ---------------------------------------------------------------------------


def train_test_split(rows: Sequence[Record], test_size: float, random_state: int
                     ) -> Tuple[List[Record], List[Record]]:
    """(train, test) as ``sklearn.model_selection.train_test_split`` with a
    float ``test_size`` gives them: ceil(test_size · n) test rows, the first
    of ``RandomState(random_state).permutation(n)``, then the rest."""
    n = len(rows)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be in (0, 1)")
    n_test = math.ceil(test_size * n)
    if n - n_test <= 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size}, the train set "
                         "would be empty")
    perm = np.random.RandomState(random_state).permutation(n)
    return [rows[i] for i in perm[n_test:]], [rows[i] for i in perm[:n_test]]


def standard_scale(x: np.ndarray) -> np.ndarray:
    """``StandardScaler().fit_transform(x)``: the mean and the population
    variance by the corrected two-pass sum; a feature whose variance is
    within rounding of zero keeps scale 1."""
    x = np.array(x, dtype=np.float64)
    n = x.shape[0]
    total = x.sum(axis=0)
    mean = total / n
    temp = x - mean
    correction = temp.sum(axis=0)
    var = ((temp ** 2).sum(axis=0) - correction ** 2 / n) / n
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.sqrt(var)
    scale[constant] = 1.0
    return (x - mean) / scale


def _sq_distances(a: np.ndarray, b: np.ndarray, b_sq: np.ndarray) -> np.ndarray:
    """‖a_i − b_j‖² as ``sklearn.metrics.pairwise._euclidean_distances`` forms
    it: −2 a·bᵀ + ‖a‖² + ‖b‖², floored at 0."""
    d = -2 * (a @ b.T)
    d += np.einsum("ij,ij->i", a, a)[:, None]
    d += b_sq[None, :]
    return np.maximum(d, 0, out=d)


def _kmeans_plusplus(x: np.ndarray, k: int, x_sq: np.ndarray,
                     rs: np.random.RandomState) -> np.ndarray:
    """Greedy k-means++ (unit weights), scikit-learn's draws in its order:
    the first centre by ``choice``, then 2 + ⌊ln k⌋ candidates per centre
    by ``uniform``, the one with the least potential kept."""
    n = x.shape[0]
    w = np.ones(n)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]))
    first = rs.choice(n, p=w / w.sum())
    centers[0] = x[first]
    closest = _sq_distances(centers[0, None], x, x_sq)
    pot = closest @ w
    for c in range(1, k):
        rand_vals = rs.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), rand_vals)
        np.clip(cand, None, closest.size - 1, out=cand)
        d = _sq_distances(x[cand], x, x_sq)
        np.minimum(closest, d, out=d)
        cand_pot = d @ w.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot = cand_pot[best]
        closest = d[best]
        centers[c] = x[cand[best]]
    return centers


def _assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Each point's nearest centre by ‖c‖² − 2 x·c (the first on a tie)."""
    d = np.einsum("ij,ij->i", centers, centers)[None, :] + (-2.0) * (x @ centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd_step(x: np.ndarray, centers: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                             np.ndarray]:
    """One E and M step: (labels, new centres, each centre's shift). An
    empty cluster takes the point farthest from its centre, as scikit-learn
    relocates it."""
    k, f = centers.shape
    labels = _assign(x, centers)
    sums = np.zeros((k, f))
    np.add.at(sums, labels, x)
    weight = np.bincount(labels, minlength=k).astype(np.float64)
    empty = np.where(weight == 0)[0]
    if empty.size:
        dist = ((x - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -empty.size)[:-empty.size - 1:-1]
        if np.max(dist) != 0:
            for new, idx in zip(empty, far):
                old = labels[idx]
                sums[old] -= x[idx]
                sums[new] = x[idx]
                weight[new] = 1.0
                weight[old] -= 1.0
    # In place and in order, as scikit-learn averages: an empty centre takes
    # the biggest cluster's row as it stands when its turn comes.
    biggest = np.argmax(weight)
    for j in range(k):
        if weight[j] > 0:
            sums[j] *= 1.0 / weight[j]
        else:
            sums[j] = sums[biggest]
    shift = np.sqrt(((sums - centers) ** 2).sum(axis=1))
    return labels, sums, shift


def _lloyd(x: np.ndarray, centers: np.ndarray, tol: float, max_iter: int = 300
           ) -> Tuple[np.ndarray, float, np.ndarray]:
    """Lloyd's iterations until the labels repeat or the summed squared
    shift is within ``tol``; then, unless the labels repeated, one more
    E-step. Returns (labels, inertia, centres)."""
    labels_old = np.full(x.shape[0], -1, dtype=np.int32)
    strict = False
    for _ in range(max_iter):
        labels, centers_new, shift = _lloyd_step(x, centers)
        centers = centers_new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(x, centers)
    inertia = float(((x - centers[labels]) ** 2).sum())
    return labels, inertia, centers


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """Whether two labelings are equal up to a permutation of the labels."""
    mapping = np.full(k, -1)
    for la, lb in zip(a, b):
        if mapping[la] == -1:
            mapping[la] = lb
        elif mapping[la] != lb:
            return False
    return True


def kmeans(x: np.ndarray, n_clusters: int, random_state: int, n_init: int = 10,
           tol: float = 1e-4) -> Tuple[np.ndarray, np.ndarray]:
    """``KMeans(n_clusters, random_state=random_state, n_init=n_init).fit``
    (k-means++, Lloyd) in numpy: (labels, cluster centres)."""
    x = np.array(x, dtype=np.float64)
    if x.shape[0] < n_clusters:
        raise ValueError(f"n_samples={x.shape[0]} should be >= n_clusters={n_clusters}.")
    tol = float(np.mean(np.var(x, axis=0)) * tol)
    rs = np.random.RandomState(random_state)
    x_mean = x.mean(axis=0)
    x -= x_mean
    x_sq = np.einsum("ij,ij->i", x, x)
    best = None
    for _ in range(n_init):
        labels, inertia, centers = _lloyd(x, _kmeans_plusplus(x, n_clusters, x_sq, rs), tol)
        if best is None or (inertia < best[1]
                            and not _same_clustering(labels, best[0], n_clusters)):
            best = (labels, inertia, centers)
    return best[0], best[2] + x_mean


# ---------------------------------------------------------------------------
# The strategies
# ---------------------------------------------------------------------------


def save_splits(train: Optional[List[Record]], val: Optional[List[Record]],
                test: Optional[List[Record]], columns: Sequence[str], output_dir: str,
                visualize: bool = False) -> None:
    """``{train,val,test}.csv`` without the splitter's work columns, and the
    optional map of the splits."""
    os.makedirs(output_dir, exist_ok=True)
    out_columns = [c for c in columns if c not in _WORK_COLUMNS]
    for name, rows in (("train", train), ("val", val), ("test", test)):
        if rows is None:
            continue
        write_csv(os.path.join(output_dir, f"{name}.csv"), rows, out_columns)
        logging.info("%s split: %d records", name, len(rows))
    if visualize:
        _visualize_splits(train, val, test, output_dir)


def _visualize_splits(train, val, test, output_dir: str) -> None:
    """Scatter of the splits' tile centres (best effort: a failure is logged)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 6))
        for name, rows, color in (("train", train, "#3b82f6"), ("val", val, "#f59e0b"),
                                  ("test", test, "#ef4444")):
            if rows is None:
                continue
            tiles = dict.fromkeys(r["mgrs_tile"] for r in rows if r["mgrs_tile"] is not None)
            pts = [(c[1], c[0]) for c in (_tile_center(t) for t in tiles) if c]
            if pts:
                xs, ys = zip(*pts)
                ax.scatter(xs, ys, s=18, label=name, color=color, alpha=0.7)
        ax.set_xlabel("Longitude")
        ax.set_ylabel("Latitude")
        ax.legend()
        fig.savefig(os.path.join(output_dir, "splits_locations.png"), dpi=120)
        plt.close(fig)
    except Exception as e:  # the map is best effort
        logging.warning("Split visualization failed: %s", e)


def _try_mgrs_groups(rows: List[Record], distance_threshold: float
                     ) -> Optional[List[Set[str]]]:
    valid = list(dict.fromkeys(r["mgrs_tile"] for r in rows if r["mgrs_tile"] is not None))
    if len(valid) < 2:
        return None
    groups = group_close_mgrs_tiles(valid, distance_threshold)
    logging.info("Created %d MGRS groups", len(groups))
    return groups


def _try_year_groups(rows: List[Record]) -> List[Set[int]]:
    years = sorted({r["year"] for r in rows if r["year"] is not None}, reverse=True)
    return [{y} for y in years]


def _mean_year(rows: List[Record]) -> float:
    years = [r["year"] for r in rows if r["year"] is not None]
    return float(np.mean(years)) if years else math.nan


def _split_data(rows: List[Record], groups: List[Set], test_ratio: float, val_ratio: float,
                include_test: bool, include_val: bool, allow_group_overlap: bool,
                rng: random.Random):
    """Group-aware split: the test set takes the groups of the latest mean
    year, the validation set groups in ``rng``'s shuffled order; returns
    (test, train, val) as row lists (None for a split left out)."""
    group_of = {v: i for i, group in enumerate(groups) for v in group}
    group_id = [group_of.get(r["mask"], -1) for r in rows]
    members: Dict[int, List[int]] = {}
    for j, g in enumerate(group_id):
        members.setdefault(g, []).append(j)

    target_test = int(len(rows) * test_ratio) if include_test else 0
    target_val = int(len(rows) * val_ratio) if include_val else 0
    group_years = [(i, _mean_year([rows[j] for j in members[i]]), len(members[i]))
                   for i in range(len(groups)) if members.get(i)]

    test_idx = None
    if include_test:
        group_years.sort(key=lambda x: x[1], reverse=True)
        picked: List[int] = []
        size = 0
        for gid, _, _ in group_years:
            if size > target_test:
                break
            picked.extend(members[gid])
            size += len(members[gid])
        test_idx = picked[:target_test]

    in_test = set(test_idx or ())
    remaining = [j for j in range(len(rows)) if j not in in_test]
    test_groups = {group_id[j] for j in in_test}
    rem_groups = (group_years if allow_group_overlap
                  else [g for g in group_years if g[0] not in test_groups])
    rng.shuffle(rem_groups)

    val_idx = None
    if include_val:
        picked = []
        size = 0
        for gid, _, _ in rem_groups:
            if size >= target_val:
                break
            idx = [j for j in members[gid] if j not in in_test]
            picked.extend(idx)
            size += len(idx)
        val_idx = picked[:target_val]

    in_val = set(val_idx or ())
    train_idx = [j for j in remaining if j not in in_val]
    if not allow_group_overlap and val_idx is not None:
        val_groups = {group_id[j] for j in in_val}
        keep = {g[0] for g in rem_groups if g[0] not in val_groups}
        train_idx = [j for j in train_idx if group_id[j] in keep]
    pick = lambda idx: None if idx is None else [rows[j] for j in idx]  # noqa: E731
    return pick(test_idx), pick(train_idx), pick(val_idx)


def _try_random_split(rows: List[Record], random_state: int, test_ratio: float = 0.2,
                      val_ratio: float = 0.2, include_test: bool = True,
                      include_val: bool = True):
    test = val = None
    train = list(rows)
    if include_test:
        train, test = train_test_split(rows, test_ratio, random_state)
    if include_val:
        adj = val_ratio / (1 - test_ratio) if include_test else val_ratio
        train, val = train_test_split(train, adj, random_state)
    return test, train, val


def _try_kmeans_split(rows: List[Record], columns: Sequence[str], n_clusters: int,
                      test_ratio: float, val_ratio: float, output_dir: str, visualize: bool,
                      random_state: int = 42, include_test: bool = True,
                      include_val: bool = True) -> None:
    """Geo-cluster split: the test and validation sets grow from the
    smallest cluster by the nearest centroids until their targets are met."""
    for r in rows:
        c = _tile_center(r["mgrs_tile"])
        r["lat"], r["lon"] = (c[0], c[1]) if c else (math.nan, math.nan)
    n_invalid = sum(1 for r in rows if math.isnan(r["lat"]) or math.isnan(r["lon"]))
    if n_invalid:
        # Rows without a resolvable MGRS position cannot be grouped by place.
        logging.warning("Filtering out %d records with unresolvable MGRS tiles — "
                        "they will appear in NO split.", n_invalid)
    rows = [r for r in rows if not (math.isnan(r["lat"]) or math.isnan(r["lon"]))]
    n_clusters = min(n_clusters, max(1, len({(r["lat"], r["lon"]) for r in rows})))
    coords = standard_scale(np.array([[r["lat"], r["lon"]] for r in rows]))
    labels, centroids = kmeans(coords, n_clusters, random_state)
    for r, label in zip(rows, labels):
        r["cluster"] = int(label)

    def count(frame: List[Record], clusters) -> int:
        return sum(1 for r in frame if r["cluster"] in clusters)

    def grow(target: int, available: Set[int], frame: List[Record]) -> Set[int]:
        chosen: Set[int] = set()
        size = 0
        while size < target and available:
            if not chosen:
                nxt = min(available, key=lambda c: count(frame, (c,)))
            else:
                nxt = min(available, key=lambda c: min(
                    np.linalg.norm(centroids[c] - centroids[s]) for s in chosen))
            available.remove(nxt)
            chosen.add(nxt)
            size = count(frame, chosen)
        return chosen

    available = set(range(n_clusters))
    test_clusters = grow(int(len(rows) * test_ratio), available, rows) if include_test else set()
    remaining = [r for r in rows if r["cluster"] not in test_clusters]
    val_clusters = (grow(int(len(rows) * val_ratio), available, remaining)
                    if include_val else set())

    test = [r for r in rows if r["cluster"] in test_clusters]
    val = [r for r in remaining if r["cluster"] in val_clusters]
    train = [r for r in remaining if r["cluster"] in available]
    logging.info("KMeans splits: test=%d val=%d train=%d", len(test), len(val), len(train))
    save_splits(train, val, test, columns, output_dir, visualize)


def split_dataset(
    rows: Sequence[Record],
    columns: Sequence[str],
    val_ratio: float = 0.15,
    test_ratio: float = 0.15,
    random_state: int = 42,
    save_viz: bool = True,
    include_val: bool = True,
    include_test: bool = True,
    distance_threshold: float = 400.0,
    output_dir: str = "dataset_splits",
    allow_group_overlap: bool = True,
    use_kmeans: bool = True,
    n_clusters: int = 20,
) -> None:
    """The strategy cascade over ``rows`` (a CSV's records and its
    ``columns``), writing the splits under ``output_dir``."""
    rng = random.Random(random_state)
    rows = [dict(r, mgrs_tile=extract_mgrs_tile(r["Input"]), year=extract_year(r["Input"]))
            for r in rows]

    if use_kmeans and any(r["mgrs_tile"] is not None for r in rows):
        logging.info("Using KMeans clustering strategy")
        _try_kmeans_split(rows, columns, n_clusters, test_ratio, val_ratio, output_dir,
                          save_viz, random_state=random_state, include_test=include_test,
                          include_val=include_val)
        return

    mgrs_groups = _try_mgrs_groups(rows, distance_threshold)
    if mgrs_groups and len(mgrs_groups) >= 2:
        logging.info("Using MGRS tile grouping strategy")
        for r in rows:
            r["mask"] = r["mgrs_tile"]
        test, train, val = _split_data(rows, mgrs_groups, test_ratio, val_ratio, include_test,
                                       include_val, allow_group_overlap, rng)
        save_splits(train, val, test, columns, output_dir, save_viz)
        return

    year_groups = _try_year_groups(rows)
    if len(year_groups) >= 2:
        logging.info("Using year-based splitting strategy")
        for r in rows:
            r["mask"] = r["year"]
        test, train, val = _split_data(rows, year_groups, test_ratio, val_ratio, include_test,
                                       include_val, allow_group_overlap, rng)
        save_splits(train, val, test, columns, output_dir, save_viz)
        return

    logging.info("Using random splitting strategy")
    test, train, val = _try_random_split(rows, random_state, test_ratio, val_ratio,
                                         include_test, include_val)
    save_splits(train, val, test, columns, output_dir, save_viz)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Entry point; ``argv`` without the program name (``sys.argv[1:]`` by
    default)."""
    flags = _flags.parse_flags(sys.argv[1:] if argv is None else argv, SPLITTER_FLAGS,
                               prog="instageo_tpu_torch.data.data_splitter")
    rows, columns = read_csv(flags.input_file)
    split_dataset(
        rows, columns,
        val_ratio=flags.val_ratio,
        test_ratio=flags.test_ratio,
        random_state=flags.random_state,
        save_viz=flags.visualize,
        include_val=flags.include_val,
        include_test=flags.include_test,
        distance_threshold=flags.distance_threshold,
        output_dir=flags.output_dir,
        allow_group_overlap=flags.allow_group_overlap,
        use_kmeans=flags.use_kmeans,
        n_clusters=flags.n_clusters,
    )


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
