"""``plot`` stage: heatmap / pairwise scatter / minor-allele line plots.

Capability parity with reference tracs/plots.py:457-487 (three plot types
sharing a pileup-frequency reader), redesigned around flat arrays instead
of per-contig DataFrame loops:

* frequencies live in ONE stacked ``[L_total, 4]`` float matrix per sample
  (contigs concatenated, an offset table mapping rows back to contigs) —
  the reference re-melts a per-contig dict of DataFrames per plot
  (plots.py:262-334);
* site selections (match / all-mismatch / variable / min-freq band) are
  boolean masks over that matrix, and the long-format plot tables are
  built in one shot from ``np.nonzero`` of the final mask — value- and
  ordering-compatible with the reference's melt output (column order,
  allele-major emission, 1-based positions);
* the heatmap's symmetric matrix is assembled by integer-coded scatter
  fill + transpose fallback rather than pivot/combine_first
  (plots.py:133-179), then single-linkage leaf-ordered the same way.

The scatter plot is interactive plotly HTML in the reference; plotly is
optional here — when unavailable the same data CSV is written and a static
matplotlib PNG is produced instead.
"""

from __future__ import annotations

import argparse
import gzip
import logging
import os

import numpy as np
from scipy.cluster.hierarchy import leaves_list, linkage


def _pyplot():
    """matplotlib.pyplot on the headless Agg backend, imported on first
    plot: the other stages must not need matplotlib to start."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt

_ALLELES = np.array(list("ACGT"))
_ALLELE_COLORS = {"A": "#e41a1c", "C": "#377eb8", "G": "#4daf4a", "T": "#984ea3"}


def plots_parser(parser):
    parser.description = "Generates plots from a pileup file."

    io_opts = parser.add_argument_group("Input/output")
    io_opts.add_argument(
        "-i", "--input", dest="input_files", required=True,
        help="input file(s): a distance csv (heatmap) or two pileups "
             "(scatter/line)",
        type=os.path.abspath, nargs="+",
    )
    io_opts.add_argument(
        "-p", "--prefix", dest="output_file", required=True,
        help="prefix of output file", type=os.path.abspath,
    )
    io_opts.add_argument(
        "--type", dest="plot_type", required=True,
        help="Type of plot (scatter, line, heatmap)",
        choices=["scatter", "line", "heatmap"], type=str,
    )

    pileup = parser.add_argument_group("Pileup options")
    pileup.add_argument("--min-freq", dest="min_freq", type=float, default=0.0,
                        help="minimum frequency to include a variant (default=0.0)")
    pileup.add_argument("--either-strand", dest="require_both_strands",
                        action="store_false", default=True,
                        help="turns off the requirement that a variant is supported by "
                             "both strands")
    pileup.add_argument("--contigs", dest="contigs", default=["All"], type=str,
                        nargs="+", help="contigs for plotting (default=All)")

    distance = parser.add_argument_group("Transmission distance options")
    distance.add_argument("--column-name", dest="column_name", type=str,
                          default="SNP distance",
                          help="Column name in distance matrix to use "
                               "(default='SNP distance')")
    distance.add_argument("--threshold", dest="threshold", type=float, default=None,
                          help="threshold to filter transmission distances (default=None)")

    plot = parser.add_argument_group("Plot options")
    plot.add_argument("--alpha", dest="alpha", type=float, default=0.1,
                      help="alpha value for plotting (default=0.1)")
    plot.add_argument("--height", dest="height", type=float, default=7,
                      help="height value for plotting (default=7)")
    plot.add_argument("--width", dest="width", type=float, default=10,
                      help="width value for plotting (default=10)")

    parser.set_defaults(func=plots)
    return parser


def open_file(file_path):
    if file_path.endswith(".gz"):
        return gzip.open(file_path, "rt")
    return open(file_path, "r")


def _sample_label(path: str) -> str:
    return os.path.basename(path).replace(".txt.gz", "")


# ---------------------------------------------------------------------------
# heatmap
# ---------------------------------------------------------------------------


def _symmetric_distance_matrix(df: "pd.DataFrame", names: list[str]) -> np.ndarray:
    """[n, n] float matrix of the 'SNP distance' column over ``names``.

    Direct (A, B) entries win; missing cells fall back to the transposed
    (B, A) entry; cells present in neither direction stay NaN.  (The value
    column is always 'SNP distance' regardless of the threshold column —
    a reference quirk preserved from plots.py:142.)
    """
    code = {s: i for i, s in enumerate(names)}
    n = len(names)
    mat = np.full((n, n), np.nan)
    ia = df["sampleA"].map(code).to_numpy()
    ib = df["sampleB"].map(code).to_numpy()
    mat[ia, ib] = df["SNP distance"].to_numpy(dtype=float)
    mirrored = mat.T.copy()
    take = np.isnan(mat) & ~np.isnan(mirrored)
    mat[take] = mirrored[take]
    return mat


def _single_linkage_order(mat: np.ndarray) -> np.ndarray:
    """Leaf order from single-linkage over the matrix ROWS as observation
    vectors, with NaN (never-compared) cells pushed far away — the same
    ordering recipe the reference uses for its heatmap axes."""
    far = np.nanmax(mat) + 100
    filled = np.where(np.isnan(mat), far, mat)
    return leaves_list(linkage(filled, method="single"))


def plot_heatmap(distance_file, outfile, column="SNP distance", threshold=None,
                 height=7, width=10):
    import pandas as pd

    plt = _pyplot()
    df = pd.read_csv(distance_file)
    if threshold is not None:
        df = df[df[column] <= threshold]

    names = sorted(set(df["sampleA"]).union(df["sampleB"]))
    mat = _symmetric_distance_matrix(df, names)
    order = _single_linkage_order(mat)
    labels = [names[i] for i in order]

    fig, ax = plt.subplots(figsize=(width, height))
    img = ax.matshow(mat[np.ix_(order, order)], cmap="viridis")
    fig.colorbar(img).set_label(column)
    ax.set_xticks(range(len(labels)), labels, rotation=90)
    ax.set_yticks(range(len(labels)), labels)
    plt.title("Heatmap of " + column)
    plt.savefig(outfile + ".png", dpi=300, bbox_inches="tight")
    plt.close(fig)


# ---------------------------------------------------------------------------
# pileup frequencies (shared by scatter + line)
# ---------------------------------------------------------------------------


def read_pileup(inputfile, contig_length, require_both_strands=True, keep_contigs="All"):
    """Per-contig [L, 4] allele-frequency matrices.

    Same output contract as reference plots.py:182-212 (rows are per-site
    A/C/G/T counts normalised by max(1, site depth); uncovered sites stay
    all-zero; non-ACGT alleles or reference bases contribute nothing), but
    the parse itself goes through the shared pileup reader — the native C++
    codec with its Python fallback (io/pileup.py) — instead of a second
    per-line Python loop."""
    from tracs_tpu.io.pileup import parse_pileup

    wanted = {
        c: int(n) for c, n in contig_length.items()
        if ("All" in keep_contigs) or (c in keep_contigs)
    }
    counts = parse_pileup(inputfile, wanted, require_both_strands)
    freqs = counts / np.maximum(1.0, counts.sum(axis=1, keepdims=True))
    split_at = np.cumsum([n for n in wanted.values()])[:-1]
    return dict(zip(wanted, np.split(freqs, split_at)))


def _contig_lengths(count_file_A, count_file_B, keep_contigs):
    """Union of contig -> max position over both pileups, in order of first
    appearance (file A's contigs first).  Raises when the files share no
    contig names (reference plots.py:244-246)."""
    per_file = []
    for path in (count_file_A, count_file_B):
        lengths: dict[str, int] = {}
        with open_file(path) as fh:
            for line in fh:
                fields = line.split(maxsplit=2)
                contig = fields[0]
                if ("All" in keep_contigs) or (contig in keep_contigs):
                    pos = int(fields[1])
                    if lengths.get(contig, 0) < pos:
                        lengths[contig] = pos
        per_file.append(lengths)

    la, lb = per_file
    if not set(la) & set(lb):
        raise ValueError("No contig names match!")
    merged = {c: max(n, lb.get(c, 0)) for c, n in la.items()}
    merged.update({c: n for c, n in lb.items() if c not in la})
    return merged


class _Stacked:
    """Contig-stacked view of a read_pileup result: one [L_total, 4]
    frequency matrix plus the bookkeeping to label rows by contig and
    local position.  All site selections below are vectorised over this."""

    def __init__(self, freqs_by_contig: dict[str, np.ndarray]):
        self.contigs = list(freqs_by_contig)
        sizes = [freqs_by_contig[c].shape[0] for c in self.contigs]
        self.freq = (
            np.concatenate([freqs_by_contig[c] for c in self.contigs])
            if self.contigs else np.zeros((0, 4))
        )
        self.starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        # contig index and 0-based local position of every stacked row
        self.contig_idx = np.repeat(np.arange(len(sizes)), sizes)
        self.local_pos = np.arange(self.freq.shape[0]) - self.starts[self.contig_idx]


def _long_frame(st: _Stacked, keep: np.ndarray, sample_label: str,
                positions: np.ndarray | None = None) -> dict[str, np.ndarray]:
    """Column arrays of the long-format rows selected by the [L, 4] boolean
    ``keep`` mask, ordered (contig, allele, position) — the order the
    reference's per-contig melt loop emits.  ``positions`` overrides the
    0-based position vector (the line plot numbers positions within its
    selected-site subset)."""
    site, allele = np.nonzero(keep)
    order = np.lexsort(((positions if positions is not None else st.local_pos)[site],
                        allele, st.contig_idx[site]))
    site, allele = site[order], allele[order]
    pos0 = (positions if positions is not None else st.local_pos)[site]
    return {
        "position": pos0 + 1,
        "allele": _ALLELES[allele],
        "frequency": st.freq[site, allele],
        "sample": np.repeat(sample_label, len(site)),
        "contig": np.asarray(st.contigs, dtype=object)[st.contig_idx[site]],
        "_site": site,
        "_allele": allele,
    }


# ---------------------------------------------------------------------------
# scatter
# ---------------------------------------------------------------------------


def _pairwise_frame(count_file_A, count_file_B, fA, fB, min_freq, with_match=True):
    """Long-format site/allele table for the pairwise scatter.

    Selection semantics (value-parity with reference plots.py:262-334):
      * ``match``        — allele present (>0) in both samples at the site;
      * ``allmismatch``  — both samples covered but NO shared allele;
      * ``variable``     — >1 allele with summed frequency above min_freq;
      * rows need frequency >= min_freq AND (frequency <= 1-min_freq OR
        variable OR allmismatch) — fixed near-1.0 calls shared by both
        samples are uninformative and dropped.

    Everything is one pass of boolean masks over the stacked [L, 4]
    matrices; rows come out (sample, contig, allele, position)-ordered
    like the reference's melt loop.  Returns a DataFrame or None.
    """
    import pandas as pd

    sa, sb = _Stacked(fA), _Stacked(fB)
    present_a, present_b = sa.freq > 0, sb.freq > 0
    match = present_a & present_b                                   # [L, 4]
    covered = present_a.any(axis=1) & present_b.any(axis=1)         # [L]
    allmismatch = covered & ~match.any(axis=1)
    variable = ((sa.freq + sb.freq) > min_freq).sum(axis=1) > 1

    frames = []
    for st, path in ((sa, count_file_A), (sb, count_file_B)):
        keep = (st.freq >= min_freq) & (
            (st.freq <= 1 - min_freq) | variable[:, None] | allmismatch[:, None]
        )
        cols = _long_frame(st, keep, _sample_label(path))
        site, allele = cols.pop("_site"), cols.pop("_allele")
        frames.append(pd.DataFrame({
            "position": cols["position"],
            "allmismatch": allmismatch[site],
            "variable": variable[site],
            "allele": cols["allele"],
            "frequency": cols["frequency"],
            "match": match[site, allele],
            "sample": cols["sample"],
            "contig": cols["contig"],
        }))
    pdf = pd.concat(frames, ignore_index=True)
    return pdf if len(pdf) else None


def plot_pairwise_scatter(count_file_A, count_file_B, outfile,
                          require_both_strands=True, min_freq=0.01,
                          keep_contigs="All"):
    logging.info("Counting entries in pileup files...")
    contig_length = _contig_lengths(count_file_A, count_file_B, keep_contigs)

    logging.info("Generating frequency matrices...")
    fA = read_pileup(count_file_A, contig_length, require_both_strands, keep_contigs)
    fB = read_pileup(count_file_B, contig_length, require_both_strands, keep_contigs)

    logging.info("Computing pairwise comparisons...")
    pdf = _pairwise_frame(count_file_A, count_file_B, fA, fB, min_freq)
    if pdf is None:
        logging.warning("Nothing to plot!")
        return
    pdf.to_csv(outfile + ".csv", index=False)

    # interactive HTML, always (reference plot scatter always emits plotly
    # HTML, reference tracs/plots.py:214-334): the figure JSON is built
    # here from the already-assembled frame and embedded in a page with a
    # plotly.js script tag — no plotly python package needed.  The static
    # PNG also writes by default (the interactive render needs one
    # script fetch, and air-gapped hosts deserve a viewable artifact);
    # TRACS_TPU_SCATTER_PNG=0 skips it.
    _scatter_html(pdf, outfile)
    if os.environ.get("TRACS_TPU_SCATTER_PNG", "1") != "0":
        _scatter_png(pdf, outfile)


#: pinned plotly.js — any 2.x renders the scatter/scattergl traces below
_PLOTLY_JS_CDN = "https://cdn.plot.ly/plotly-2.35.2.min.js"


def _scatter_fig_json(pdf):
    """Plotly figure dict for the pairwise scatter: a (sample-row x
    contig-column) facet grid, alleles colored, matching alleles filled /
    non-matching open — the same visual contract as the reference's
    ``px.scatter(..., facet_col='contig', facet_row='sample',
    color='allele', symbol='match')`` (reference tracs/plots.py:303-322)."""
    samples = list(dict.fromkeys(pdf["sample"]))
    contigs = list(dict.fromkeys(pdf["contig"]))
    nrow, ncol = len(samples), len(contigs)
    data = []
    layout = {
        "grid": {"rows": nrow, "columns": ncol, "pattern": "independent"},
        "legend": {"title": {"text": "allele / match"}},
        "margin": {"t": 40},
    }
    seen_legend = set()
    for si, sample in enumerate(samples):
        for ci, contig in enumerate(contigs):
            idx = si * ncol + ci + 1
            ax = "" if idx == 1 else str(idx)
            panel = pdf[(pdf["sample"] == sample) & (pdf["contig"] == contig)]
            for allele, color in _ALLELE_COLORS.items():
                for is_match, symbol in ((True, "circle"), (False, "circle-open")):
                    rows = panel[
                        (panel["allele"] == allele)
                        & (panel["match"].astype(bool) == is_match)
                    ]
                    if not len(rows):
                        continue
                    name = f"{allele} ({'match' if is_match else 'mismatch'})"
                    trace = {
                        "type": "scattergl",
                        "mode": "markers",
                        "x": rows["position"].tolist(),
                        "y": [round(v, 6) for v in rows["frequency"]],
                        "xaxis": "x" + ax,
                        "yaxis": "y" + ax,
                        "name": name,
                        "legendgroup": name,
                        "showlegend": name not in seen_legend,
                        "marker": {
                            "color": color, "symbol": symbol,
                            "opacity": 0.7, "size": 6,
                        },
                        "hovertemplate": (
                            f"{sample} / {contig}<br>allele={allele} "
                            f"match={is_match}<br>position=%{{x}}"
                            f"<br>frequency=%{{y}}<extra></extra>"
                        ),
                    }
                    seen_legend.add(name)
                    data.append(trace)
            layout["xaxis" + ax] = {"title": {"text": f"position ({contig})"}}
            layout["yaxis" + ax] = {
                "title": {"text": f"frequency<br>{sample}"} if ci == 0 else {},
                "range": [-0.05, 1.05],
            }
    return {"data": data, "layout": layout}


def _scatter_html(pdf, outfile):
    """Write ``outfile``.html: the figure JSON embedded in the page, the
    plotly.js LIBRARY loaded from its CDN script tag (like plotly's own
    'cdn' include mode).  The data needs no further fetch; the
    interactive render needs that one script, so the default PNG covers
    offline viewing."""
    import json as _json

    fig = _scatter_fig_json(pdf)
    html = (
        "<!DOCTYPE html>\n<html><head><meta charset=\"utf-8\">\n"
        "<title>tracs-tpu pairwise scatter</title>\n"
        f"<script src=\"{_PLOTLY_JS_CDN}\" charset=\"utf-8\"></script>\n"
        "</head><body>\n"
        "<div id=\"tracs-scatter\" style=\"width:100%;height:96vh;\"></div>\n"
        "<script>\nconst fig = "
        + _json.dumps(fig, separators=(",", ":"))
        + ";\nPlotly.newPlot(\"tracs-scatter\", fig.data, fig.layout,"
        " {responsive: true});\n</script>\n</body></html>\n"
    )
    with open(outfile + ".html", "w") as fh:
        fh.write(html)
    logging.info("wrote interactive scatter: %s.html", outfile)


def _scatter_png(pdf, outfile):
    """Static fallback: one panel per (sample, contig), filled markers for
    matching alleles, open markers otherwise."""
    plt = _pyplot()
    samples = pdf["sample"].unique()
    contigs = pdf["contig"].unique()
    fig, axes = plt.subplots(
        len(samples), len(contigs), figsize=(10, 7), squeeze=False, sharey=True
    )
    for (si, sample), (ci, contig) in (
        ((si, s), (ci, c))
        for si, s in enumerate(samples) for ci, c in enumerate(contigs)
    ):
        panel = pdf[(pdf["sample"] == sample) & (pdf["contig"] == contig)]
        ax = axes[si][ci]
        for allele, color in _ALLELE_COLORS.items():
            rows = panel[panel["allele"] == allele]
            hit = rows["match"].to_numpy(dtype=bool)
            ax.scatter(rows["position"][hit], rows["frequency"][hit], s=8,
                       color=color, alpha=0.7, label=allele)
            ax.scatter(rows["position"][~hit], rows["frequency"][~hit], s=8,
                       facecolors="none", edgecolors=color, alpha=0.7)
        ax.set_ylim(-0.05, 1.05)
        ax.set_title(f"{sample} / {contig}", fontsize=8)
    axes[0][0].legend(fontsize=6)
    plt.savefig(outfile + ".png", dpi=300, bbox_inches="tight")
    plt.close(fig)


# ---------------------------------------------------------------------------
# line
# ---------------------------------------------------------------------------


def plot_pairwise_line(count_file_A, count_file_B, outfile, keep_contigs="All",
                       require_both_strands=True, min_freq=0.01, alpha=0.1,
                       height=7, width=10):
    """Minor-allele frequency shift lines at consensus-differing sites.

    Site selection (value-parity with reference plots.py:336-455): keep
    sites whose argmax allele differs between the samples, then alleles
    with frequency inside [min_freq, 1-min_freq], then drop (allele,
    contig, position) singletons so every drawn line has both endpoints.
    The CSV's ``position`` column numbers sites WITHIN the selected
    subset, 1-based — a reference quirk (its per-contig DataFrame is
    built from the boolean-indexed subset, so reset_index renumbers).
    """
    import pandas as pd
    from matplotlib.collections import LineCollection

    plt = _pyplot()
    logging.info("Counting entries in pileup files...")
    contig_length = _contig_lengths(count_file_A, count_file_B, keep_contigs)

    logging.info("Generating frequency matrices...")
    fA = read_pileup(count_file_A, contig_length, require_both_strands, keep_contigs)
    fB = read_pileup(count_file_B, contig_length, require_both_strands, keep_contigs)

    sa, sb = _Stacked(fA), _Stacked(fB)
    diff = sa.freq.argmax(axis=1) != sb.freq.argmax(axis=1)  # [L]
    # subset-local position per site: rank among selected sites of the
    # same contig (only meaningful where diff holds)
    rank_all = np.cumsum(diff) - 1
    first_of_contig = np.zeros(len(diff), dtype=np.int64)
    for c in range(len(sa.contigs)):
        rows = sa.contig_idx == c
        sel = diff & rows
        first_of_contig[rows] = rank_all[sel][0] if sel.any() else 0
    subset_pos = rank_all - first_of_contig

    frames = []
    for st, path, code in ((sa, count_file_A, 1), (sb, count_file_B, 0)):
        band = (st.freq >= min_freq) & (st.freq <= 1 - min_freq)
        cols = _long_frame(st, band & diff[:, None], _sample_label(path),
                           positions=subset_pos)
        cols.pop("_site"), cols.pop("_allele")
        cols["sample_code"] = np.repeat(code, len(cols["position"]))
        frames.append(pd.DataFrame(cols))
    pdf = pd.concat(frames, ignore_index=True)
    if not len(pdf):
        logging.warning("Nothing to plot!")
        return

    # drop singleton (allele, contig, position) groups; remaining groups
    # are the line segments (one endpoint per sample)
    key = pd.MultiIndex.from_frame(pdf[["allele", "contig", "position"]])
    counts = key.value_counts()
    pdf = pdf[key.isin(counts[counts > 1].index)]

    segs = [
        np.column_stack([grp["sample_code"], grp["frequency"]])
        for _k, grp in pdf.groupby(["allele", "contig", "position"], sort=True)
    ]
    fig, ax = plt.subplots(figsize=(width, height))
    ax.add_collection(LineCollection(segs, linewidths=0.5, alpha=alpha))
    ax.set_xticks([0, 1])
    ax.set_xticklabels(
        [os.path.basename(p).split(".")[0] for p in (count_file_A, count_file_B)],
        rotation=90,
    )
    ax.set_xlabel("Sample")
    ax.set_ylabel("Frequency")
    ax.set_title("Minor allele frequency by sample")
    plt.savefig(outfile + ".png", dpi=300, bbox_inches="tight")
    plt.close(fig)
    pdf.to_csv(outfile + ".csv", index=False)


def plots(args):
    logging.basicConfig(
        format="%(asctime)s - %(message)s", datefmt="%d-%b-%y %H:%M:%S",
        level=logging.INFO,
    )
    if args.plot_type == "scatter":
        plot_pairwise_scatter(
            args.input_files[0], args.input_files[1], args.output_file,
            require_both_strands=args.require_both_strands,
            min_freq=args.min_freq, keep_contigs=args.contigs,
        )
    elif args.plot_type == "line":
        plot_pairwise_line(
            args.input_files[0], args.input_files[1], args.output_file,
            require_both_strands=args.require_both_strands,
            min_freq=args.min_freq, keep_contigs=args.contigs,
            alpha=args.alpha, height=args.height, width=args.width,
        )
    elif args.plot_type == "heatmap":
        plot_heatmap(
            args.input_files[0], args.output_file, column=args.column_name,
            threshold=args.threshold, height=args.height, width=args.width,
        )


def main():
    parser = argparse.ArgumentParser()
    parser = plots_parser(parser)
    args = parser.parse_args()
    args.func(args)


if __name__ == "__main__":
    main()
