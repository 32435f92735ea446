"""The web-crawl family: the directed link graph of pages in crawl order.

Pages are numbered in crawl order and grouped into sites of ``site``
consecutive pages. Each page's out-degree is drawn from a power law
(Pareto tail index ``alpha``, at least one link, at most ``max_row``;
the page with the largest draw gets exactly ``max_row``). A page with
at least ``nav_from`` links is a navigation page: its links are the
first of its site's list, an ordering of the 2 ``window`` + 1 pages
around the site, so the navigation pages of one site link to nested
prefixes of one list. Every other page sends each link, with
probability ``hub_share``, to one of its site's navigation pages (drawn
uniformly), and otherwise to a page of its site drawn uniformly.

So in-links gather on the pages with many out-links, which is what makes
C = A @ A's work (the sum over pages of in-degree x out-degree) many
times nnz; ``hub_share`` sets that work. A page that links to several
navigation pages of one site reaches their shared list more than once,
which merges products into one entry of C; ``site`` sets how often.
Duplicate links are dropped; there is no diagonal but by chance.
``spec`` is a configuration file's dict: m, n, nnz, alpha, max_row,
site, window, nav_from, hub_share.
"""

import numpy as np
import scipy.sparse as sp


def build(spec, seed, scale=1.0):
    m = spec["m"]
    if m != spec["n"]:
        raise ValueError("a link graph is square")
    site, window, dmax = spec["site"], spec["window"], spec["max_row"]
    if 2 * window + 1 < dmax:
        raise ValueError("a site's list must hold the longest row")
    rng = np.random.default_rng(seed)
    y = rng.pareto(spec["alpha"], m) + 1.0
    d = np.minimum(np.floor(scale * y), dmax).astype(np.int64)
    d[np.argmax(y)] = dmax
    start = np.concatenate([[0], np.cumsum(d)])
    rows = np.repeat(np.arange(m), d)
    nth = np.arange(rows.size) - start[rows]        # a link's place in its row
    s = rows // site
    # each site's list: an affine permutation of the pages around it
    span = 2 * window + 1
    n_sites = -(-m // site)
    mult = rng.integers(1, span, n_sites)
    while True:          # a multiplier coprime with span permutes it
        bad = np.gcd(mult, span) != 1
        if not bad.any():
            break
        mult[bad] = rng.integers(1, span, int(bad.sum()))
    shift = rng.integers(0, span, n_sites)
    first = np.clip(s * site + site // 2 - window, 0, m - span)
    listed = first[s] + (mult[s] * nth + shift[s]) % span
    # the rest: a navigation page of the site, or any page of it
    nav = d >= spec["nav_from"]
    lo = s * site
    hi = np.minimum(lo + site, m)
    cnav = np.concatenate([[0], np.cumsum(nav)])
    n_hubs = cnav[hi] - cnav[lo]
    u = rng.random(rows.size)
    hub = (rng.random(rows.size) < spec["hub_share"]) & (n_hubs > 0)
    hub_rank = cnav[lo] + np.minimum(
        np.floor(u * n_hubs).astype(np.int64), np.maximum(n_hubs - 1, 0))
    hubs = np.nonzero(nav)[0]
    to_hub = hubs[np.minimum(hub_rank, max(hubs.size - 1, 0))] \
        if hubs.size else lo
    anywhere = lo + np.floor(u * (hi - lo)).astype(np.int64)
    cols = np.where(nav[rows], listed, np.where(hub, to_hub, anywhere))
    A = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(m, m))
    A.sum_duplicates()
    A.data[:] = 1.0
    return A
