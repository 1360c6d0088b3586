// The host fusion's global merge and consensus filter, indexed by a
// uniform grid (C++, double precision).
//
// `native/geom.cpp` scans every kept box (greedy_nms) or every other row
// (consensus_filter) for each row. Here each row tests only the rows that
// share a grid cell with its axis-aligned bounding box (AABB). That is
// exact for a positive threshold: two boxes whose AABBs share no cell do
// not overlap, so their IoU is 0 and the pair cannot pass. The candidates
// are visited in the order the all-pairs scan visits them (ascending keep
// position, ascending row), so the kept rows, their order and the
// consensus filter's (conf, then IoU) tie-breaking are those of
// `native/geom.cpp`, bit for bit. Where the threshold is not positive, or
// a coordinate is not finite, the grid is one cell: the all-pairs scan.
//
// The geometry is `native/geom.cpp`'s own, included into this translation
// unit, so the library exports both the all-pairs and the grid functions.

#include "../../native/geom.cpp"

#include <vector>

namespace {

// A uniform grid over the rows' AABBs. The cell's side is the median of
// the rows' larger AABB side, so a typical box covers one to four cells;
// it doubles while the grid would hold more than about 4n cells or the
// boxes would register in more than about 32n cells together. A box is
// registered in every cell its AABB covers.
struct Grid {
    double x0 = 0.0, y0 = 0.0, side = 1.0;
    int nx = 1, ny = 1;

    int cx(double x) const {
        if (nx == 1) return 0;
        double c = std::floor((x - x0) / side);
        return c <= 0.0 ? 0 : (c >= nx - 1 ? nx - 1 : (int)c);
    }
    int cy(double y) const {
        if (ny == 1) return 0;
        double c = std::floor((y - y0) / side);
        return c <= 0.0 ? 0 : (c >= ny - 1 ? ny - 1 : (int)c);
    }
    // The cells [c0x, c1x] x [c0y, c1y] that an AABB covers. cx and cy
    // never decrease with the coordinate, so two AABBs that overlap share
    // a cell.
    void span(const AABB& b, int& c0x, int& c0y, int& c1x, int& c1y) const {
        c0x = cx(b.x0);
        c1x = cx(b.x1);
        c0y = cy(b.y0);
        c1y = cy(b.y1);
    }
    int cells() const { return nx * ny; }
};

long long covered(const Grid& g, const AABB* boxes, int n) {
    long long total = 0;
    for (int i = 0; i < n; ++i) {
        int ax, ay, bx, by;
        g.span(boxes[i], ax, ay, bx, by);
        total += (long long)(bx - ax + 1) * (by - ay + 1);
    }
    return total;
}

Grid make_grid(const AABB* boxes, int n, bool prescreen) {
    Grid g;
    if (!prescreen || n < 2) return g;
    double x0 = boxes[0].x0, y0 = boxes[0].y0;
    double x1 = boxes[0].x1, y1 = boxes[0].y1;
    std::vector<double> sizes(n);
    for (int i = 0; i < n; ++i) {
        const AABB& b = boxes[i];
        if (!(std::isfinite(b.x0) && std::isfinite(b.y0) &&
              std::isfinite(b.x1) && std::isfinite(b.y1)))
            return g;
        x0 = std::min(x0, b.x0);
        y0 = std::min(y0, b.y0);
        x1 = std::max(x1, b.x1);
        y1 = std::max(y1, b.y1);
        sizes[i] = std::max(b.x1 - b.x0, b.y1 - b.y0);
    }
    double ext = std::max(x1 - x0, y1 - y0);
    if (!(ext > 0.0) || !std::isfinite(ext)) return g;
    std::nth_element(sizes.begin(), sizes.begin() + n / 2, sizes.end());
    double side = sizes[n / 2];
    if (!(side > 0.0)) side = ext / n;
    const double max_cells = 4.0 * n + 16.0;
    const long long max_covered = 32LL * n + 1024;
    g.x0 = x0;
    g.y0 = y0;
    for (;;) {
        double fx = std::floor((x1 - x0) / side) + 1.0;
        double fy = std::floor((y1 - y0) / side) + 1.0;
        if (fx * fy <= max_cells) {
            g.side = side;
            g.nx = (int)fx;
            g.ny = (int)fy;
            if (g.cells() == 1 || covered(g, boxes, n) <= max_covered)
                return g;
        }
        side *= 2.0;
    }
}

// Each cell's items, ascending, as CSR (`start`, `items`): item i is
// registered in every cell that boxes[i] covers.
struct Index {
    std::vector<int> start, items;
};

Index build_index(const Grid& g, const AABB* boxes, int n) {
    Index ix;
    ix.start.assign(g.cells() + 1, 0);
    for (int i = 0; i < n; ++i) {
        int ax, ay, bx, by;
        g.span(boxes[i], ax, ay, bx, by);
        for (int y = ay; y <= by; ++y)
            for (int x = ax; x <= bx; ++x) ++ix.start[y * g.nx + x + 1];
    }
    for (int c = 0; c < g.cells(); ++c) ix.start[c + 1] += ix.start[c];
    ix.items.resize(ix.start[g.cells()]);
    std::vector<int> fill(ix.start.begin(), ix.start.end() - 1);
    for (int i = 0; i < n; ++i) {
        int ax, ay, bx, by;
        g.span(boxes[i], ax, ay, bx, by);
        for (int y = ay; y <= by; ++y)
            for (int x = ax; x <= bx; ++x)
                ix.items[fill[y * g.nx + x]++] = i;
    }
    return ix;
}

// The items below `end` listed in the cells that `box` covers, each once
// and in ascending order, into `out`. `stamp`/`mark` drop repeats.
void gather(const Grid& g, const Index& ix, const AABB& box, int end,
            std::vector<int>& stamp, int mark, std::vector<int>& out) {
    const int* start = ix.start.data();
    const int* items = ix.items.data();
    int c0x, c0y, c1x, c1y;
    g.span(box, c0x, c0y, c1x, c1y);
    out.clear();
    if (c0x == c1x && c0y == c1y) {
        int c = c0y * g.nx + c0x;
        const int* last = std::lower_bound(items + start[c],
                                           items + start[c + 1], end);
        out.assign(items + start[c], last);
        return;
    }
    for (int y = c0y; y <= c1y; ++y)
        for (int x = c0x; x <= c1x; ++x) {
            int c = y * g.nx + x;
            for (int p = start[c]; p < start[c + 1] && items[p] < end; ++p) {
                int k = items[p];
                if (stamp[k] != mark) {
                    stamp[k] = mark;
                    out.push_back(k);
                }
            }
        }
    std::sort(out.begin(), out.end());
}

}  // namespace

extern "C" {

// greedy_nms over a grid: the same kept indices, in the same order.
// pairs[0] counts the (row, kept row) pairs tested, pairs[1] those the
// all-pairs scan tests (up to its first suppressing kept row).
int greedy_nms_grid(const double* dets, int n, double iou_thr,
                    int* keep_out, long long* pairs) {
    pairs[0] = pairs[1] = 0;
    if (n <= 0) return 0;
    std::vector<int> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        return dets[a * 11 + 9] > dets[b * 11 + 9];
    });
    // quads and boxes by rank in the conf order; a row's keep position
    // grows with its rank, so ascending rank is ascending keep position
    std::vector<Pt> quads(4 * (size_t)n);
    std::vector<AABB> boxes(n);
    for (int r = 0; r < n; ++r) {
        load_quad(dets + 11 * order[r], &quads[4 * (size_t)r]);
        boxes[r] = quad_aabb(&quads[4 * (size_t)r]);
    }
    bool prescreen = iou_thr > 0.0;
    Grid g = make_grid(boxes.data(), n, prescreen);
    Index ix = build_index(g, boxes.data(), n);
    std::vector<int> pos(n, -1);  // rank -> keep position, -1 if not kept
    std::vector<int> stamp(n, -1), cand;
    int kept = 0;
    for (int r = 0; r < n; ++r) {
        int i = order[r];
        gather(g, ix, boxes[r], r, stamp, r, cand);
        int suppressor = -1;
        long long tested = 0;
        for (int q : cand) {
            if (pos[q] < 0) continue;
            ++tested;
            if (dets[i * 11 + 8] != dets[order[q] * 11 + 8]) continue;
            if (prescreen && !aabb_overlap(boxes[r], boxes[q])) continue;
            if (quad_iou_impl(&quads[4 * (size_t)r], &quads[4 * (size_t)q])
                    >= iou_thr) {
                suppressor = pos[q];
                break;
            }
        }
        pairs[0] += tested;
        pairs[1] += suppressor >= 0 ? suppressor + 1 : kept;
        if (suppressor >= 0) continue;
        pos[r] = kept;
        keep_out[kept++] = i;
    }
    return kept;
}

// consensus_filter over a grid: the same kept indices, in the same order.
// pairs[0] counts the (row, other-scale row) pairs tested, pairs[1] those
// the all-pairs scan tests.
int consensus_filter_grid(const double* dets, const int* scale_of, int n,
                          double iou_partner, double cons_low,
                          double cons_high, int* keep_out,
                          long long* pairs) {
    pairs[0] = pairs[1] = 0;
    if (n <= 0) return 0;
    std::vector<Pt> quads(4 * (size_t)n);
    std::vector<AABB> boxes(n);
    std::vector<char> visited(n, 0);
    for (int i = 0; i < n; ++i) {
        load_quad(dets + 11 * i, &quads[4 * (size_t)i]);
        boxes[i] = quad_aabb(&quads[4 * (size_t)i]);
    }
    // the rows of each row's own scale, which neither scan pairs it with
    std::vector<int> by_scale(scale_of, scale_of + n), own(n);
    std::sort(by_scale.begin(), by_scale.end());
    for (int i = 0; i < n; ++i)
        own[i] = (int)(std::upper_bound(by_scale.begin(), by_scale.end(),
                                        scale_of[i]) -
                       std::lower_bound(by_scale.begin(), by_scale.end(),
                                        scale_of[i]));
    bool prescreen = iou_partner > 0.0;
    Grid g = make_grid(boxes.data(), n, prescreen);
    Index ix = build_index(g, boxes.data(), n);
    std::vector<int> stamp(n, -1), cand;
    int kept = 0;
    for (int i = 0; i < n; ++i) {
        if (visited[i]) continue;
        double cls = dets[i * 11 + 8];
        double conf = dets[i * 11 + 9];
        gather(g, ix, boxes[i], n, stamp, i, cand);
        int best = -1;
        double best_conf = -1.0, best_iou = 0.0;
        for (int k : cand) {
            if (scale_of[k] == scale_of[i]) continue;
            ++pairs[0];
            if (visited[k]) continue;
            if (dets[k * 11 + 8] != cls) continue;
            if (prescreen && !aabb_overlap(boxes[i], boxes[k])) continue;
            double iou = quad_iou_impl(&quads[4 * (size_t)i],
                                       &quads[4 * (size_t)k]);
            if (iou >= iou_partner) {
                double cp = dets[k * 11 + 9];
                if (cp > best_conf ||
                    (cp == best_conf && iou > best_iou)) {
                    best = k;
                    best_conf = cp;
                    best_iou = iou;
                }
            }
        }
        pairs[1] += n - own[i];
        if (best < 0 || best_conf < cons_low) {
            if (conf >= cons_high) keep_out[kept++] = i;
            visited[i] = 1;
            continue;
        }
        keep_out[kept++] = (conf >= best_conf) ? i : best;
        visited[i] = 1;
        visited[best] = 1;
    }
    return kept;
}

}  // extern "C"
