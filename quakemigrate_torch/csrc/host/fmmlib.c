/*
 * =============================================================================
 * fmmlib.c -- Fast-marching eikonal solver for traveltime table generation.
 *
 * Host (CPU) component of quakemigrate_torch's LUT builders, a copy of the
 * JAX package's core/src/fmmlib.c, built with the host C compiler
 * (quakemigrate_torch/_build.py::build_host). Solves
 * |grad T| = 1 / v(x) on a regular 2-D or 3-D grid from a point source,
 * using the first/second-order upwind fast-marching method with a binary
 * min-heap narrow band. This replaces the reference's external dependencies
 * for traveltime computation (scikit-fmm for "1dfmm",
 * quakemigrate/lut/create_lut.py:268-386; and the NonLinLoc Grid2Time
 * subprocess for "1dnlloc", create_lut.py:389-533).
 *
 * Part of quakemigrate_torch. License: GPLv3.
 * =============================================================================
 */

#include <stdint.h>
#include <stdlib.h>
#include <math.h>
#include <float.h>

#define FAR 0
#define NARROW 1
#define FROZEN 2

typedef struct {
    int64_t *idx;  /* heap slot -> node index */
    int64_t *pos;  /* node index -> heap slot (or -1) */
    double *val;   /* node index -> tentative value (borrowed: tt array) */
    int64_t size;
} Heap;

static void heap_swap(Heap *h, int64_t a, int64_t b) {
    int64_t ia = h->idx[a], ib = h->idx[b];
    h->idx[a] = ib; h->idx[b] = ia;
    h->pos[ia] = b; h->pos[ib] = a;
}

static void heap_up(Heap *h, int64_t i) {
    while (i > 0) {
        int64_t p = (i - 1) / 2;
        if (h->val[h->idx[i]] < h->val[h->idx[p]]) { heap_swap(h, i, p); i = p; }
        else break;
    }
}

static void heap_down(Heap *h, int64_t i) {
    for (;;) {
        int64_t l = 2 * i + 1, r = 2 * i + 2, m = i;
        if (l < h->size && h->val[h->idx[l]] < h->val[h->idx[m]]) m = l;
        if (r < h->size && h->val[h->idx[r]] < h->val[h->idx[m]]) m = r;
        if (m == i) break;
        heap_swap(h, i, m);
        i = m;
    }
}

static void heap_push(Heap *h, int64_t node) {
    h->idx[h->size] = node;
    h->pos[node] = h->size;
    h->size++;
    heap_up(h, h->size - 1);
}

static int64_t heap_pop(Heap *h) {
    int64_t top = h->idx[0];
    h->size--;
    if (h->size > 0) {
        h->idx[0] = h->idx[h->size];
        h->pos[h->idx[0]] = 0;
        heap_down(h, 0);
    }
    h->pos[top] = -1;
    return top;
}

/*
 * Solve the upwind quadratic sum_i ((T - t_i)/h_i)^2 = s^2 over the m
 * smallest contributing axes, taking the largest m for which the solution
 * exceeds every contributing t_i (causality).
 */
static double solve_quadratic(const double *tv, const double *hv, int n,
                              double slowness) {
    double t[3], h[3];
    for (int i = 0; i < n; ++i) { t[i] = tv[i]; h[i] = hv[i]; }
    for (int i = 1; i < n; ++i) {
        double tt_ = t[i], hh = h[i];
        int j = i - 1;
        while (j >= 0 && t[j] > tt_) { t[j + 1] = t[j]; h[j + 1] = h[j]; --j; }
        t[j + 1] = tt_; h[j + 1] = hh;
    }
    double best = DBL_MAX;
    for (int m = n; m >= 1; --m) {
        double a = 0.0, b = 0.0, c = -slowness * slowness;
        for (int i = 0; i < m; ++i) {
            double w = 1.0 / (h[i] * h[i]);
            a += w;
            b -= 2.0 * w * t[i];
            c += w * t[i] * t[i];
        }
        double disc = b * b - 4.0 * a * c;
        if (disc < 0.0) continue;
        double cand = (-b + sqrt(disc)) / (2.0 * a);
        if (cand >= t[m - 1]) { best = cand; break; }
    }
    if (best == DBL_MAX) best = t[0] + slowness * h[0];
    return best;
}

typedef struct {
    const double *velocity;
    double *tt;
    uint8_t *state;
    Heap *heap;
    int64_t nx, ny, nz, sx, sy;
    double hs[3];
    int order;
} FMM;

/* Recompute the trial value of a non-frozen node from its frozen
 * neighbours and insert/update it in the narrow band. */
static void relax(FMM *m, int64_t i, int64_t j, int64_t k) {
    int64_t nb = i * m->sx + j * m->sy + k;
    if (m->state[nb] == FROZEN) return;

    const int64_t dims[3] = {m->nx, m->ny, m->nz};
    const int64_t strides[3] = {m->sx, m->sy, 1};
    const int64_t coords[3] = {i, j, k};

    double tv[3], hv[3];
    int na = 0;
    for (int ax = 0; ax < 3; ++ax) {
        if (dims[ax] == 1) continue;
        double tbest = DBL_MAX, heff = m->hs[ax];
        for (int sgn = -1; sgn <= 1; sgn += 2) {
            int64_t c1 = coords[ax] + sgn;
            if (c1 < 0 || c1 >= dims[ax]) continue;
            int64_t n1 = nb + sgn * strides[ax];
            if (m->state[n1] != FROZEN) continue;
            double t1 = m->tt[n1];
            double tcand = t1, hcand = m->hs[ax];
            if (m->order >= 2) {
                int64_t c2 = coords[ax] + 2 * sgn;
                if (c2 >= 0 && c2 < dims[ax]) {
                    int64_t n2 = nb + 2 * sgn * strides[ax];
                    if (m->state[n2] == FROZEN && m->tt[n2] <= t1) {
                        tcand = (4.0 * t1 - m->tt[n2]) / 3.0;
                        hcand = 2.0 * m->hs[ax] / 3.0;
                    }
                }
            }
            if (tcand < tbest) { tbest = tcand; heff = hcand; }
        }
        if (tbest < DBL_MAX) { tv[na] = tbest; hv[na] = heff; na++; }
    }
    if (na == 0) return;

    double cand = solve_quadratic(tv, hv, na, 1.0 / m->velocity[nb]);
    if (m->state[nb] == FAR) {
        m->tt[nb] = cand;
        m->state[nb] = NARROW;
        heap_push(m->heap, nb);
    } else if (cand < m->tt[nb]) {
        m->tt[nb] = cand;
        heap_up(m->heap, m->heap->pos[nb]);
    }
}

/*
 * fast_marching: eikonal solve on a regular (nx, ny, nz) grid (C order;
 * pass nz=1 or ny=nz=1 for lower dimensions). The source is given in
 * fractional grid indices; a small box around it is initialised
 * analytically with the local velocity to reduce source-singularity error.
 * Returns 0 on success, -1 on allocation failure.
 */
int fast_marching(const double *velocity, int64_t nx, int64_t ny, int64_t nz,
                  double dx, double dy, double dz,
                  double src_x, double src_y, double src_z,
                  int order, double *tt) {
    const int64_t n = nx * ny * nz;
    const int64_t sy = nz, sx = ny * nz;

    uint8_t *state = (uint8_t *)calloc((size_t)n, 1);
    int64_t *hidx = (int64_t *)malloc((size_t)n * sizeof(int64_t));
    int64_t *hpos = (int64_t *)malloc((size_t)n * sizeof(int64_t));
    if (!state || !hidx || !hpos) {
        free(state); free(hidx); free(hpos);
        return -1;
    }
    Heap heap = {hidx, hpos, tt, 0};
    for (int64_t i = 0; i < n; ++i) { tt[i] = DBL_MAX; hpos[i] = -1; }

    FMM m = {velocity, tt, state, &heap, nx, ny, nz, sx, sy,
             {dx, dy, dz}, order};

    int64_t si = (int64_t)floor(src_x + 0.5);
    int64_t sj = (int64_t)floor(src_y + 0.5);
    int64_t sk = (int64_t)floor(src_z + 0.5);
    if (si < 0) si = 0; if (si >= nx) si = nx - 1;
    if (sj < 0) sj = 0; if (sj >= ny) sj = ny - 1;
    if (sk < 0) sk = 0; if (sk >= nz) sk = nz - 1;
    double v_src = velocity[si * sx + sj * sy + sk];

    const int64_t R = 2;
    for (int64_t i = si - R; i <= si + R; ++i) {
        if (i < 0 || i >= nx) continue;
        for (int64_t j = sj - R; j <= sj + R; ++j) {
            if (j < 0 || j >= ny) continue;
            for (int64_t k = sk - R; k <= sk + R; ++k) {
                if (k < 0 || k >= nz) continue;
                double ddx = (i - src_x) * dx;
                double ddy = (j - src_y) * dy;
                double ddz = (k - src_z) * dz;
                int64_t node = i * sx + j * sy + k;
                tt[node] = sqrt(ddx * ddx + ddy * ddy + ddz * ddz) / v_src;
                state[node] = FROZEN;
            }
        }
    }

    /* Seed the narrow band: relax all neighbours of the frozen box */
    for (int64_t i = si - R - 1; i <= si + R + 1; ++i) {
        if (i < 0 || i >= nx) continue;
        for (int64_t j = sj - R - 1; j <= sj + R + 1; ++j) {
            if (j < 0 || j >= ny) continue;
            for (int64_t k = sk - R - 1; k <= sk + R + 1; ++k) {
                if (k < 0 || k >= nz) continue;
                relax(&m, i, j, k);
            }
        }
    }

    while (heap.size > 0) {
        int64_t node = heap_pop(&heap);
        state[node] = FROZEN;
        int64_t ci = node / sx, r = node % sx, cj = r / sy, ck = r % sy;
        if (ci > 0) relax(&m, ci - 1, cj, ck);
        if (ci < nx - 1) relax(&m, ci + 1, cj, ck);
        if (cj > 0) relax(&m, ci, cj - 1, ck);
        if (cj < ny - 1) relax(&m, ci, cj + 1, ck);
        if (ck > 0) relax(&m, ci, cj, ck - 1);
        if (ck < nz - 1) relax(&m, ci, cj, ck + 1);
    }

    free(state);
    free(hidx);
    free(hpos);
    return 0;
}
