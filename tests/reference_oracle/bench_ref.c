/* bench_ref.c — pure-C wall-clock benchmark of the compiled reference
 * library (dkogan/libdogleg), for the head-to-head cost comparison in
 * bench_cpu_ref.py.
 *
 * Three problem families, all re-implemented from this repo's model specs
 * (NOT from reference code):
 *   0: quadratic surface — libdogleg_tpu/models/quadratic_surface.py
 *      (the reference's own demo problem; see also sample.c:28-123)
 *   1: exponential curve fit — libdogleg_tpu/models/curve_fit.py
 *      (m(t;p) = p0 exp(p1 t) + p2, the BASELINE config-2 dense workload)
 *   2: 2-D grid MRF — libdogleg_tpu/models/grid_mrf.py (the config-6
 *      SPARSE workload): block priors + 4-neighbor relative
 *      measurements, solved through the reference's sparse path
 *      (dogleg_optimize2 -> cholmod_analyze/factorize/solve; here the
 *      minichol RCM+band simplicial factorization). Single instance,
 *      latency mode only.
 *
 * The model callbacks are native C, so no Python/ctypes overhead is in the
 * measured loop — the numbers are the reference library's own cost on this
 * host's CPU.
 *
 * Usage:  bench_ref instances.bin dense|products nthreads [relaxed] [latency]
 *   instances.bin (little-endian):
 *     int64 problem_id, int64 nstate, int64 nmeas, int64 n_instances,
 *     aux doubles (problem 0: gx[nmeas] gy[nmeas]; problem 1: t[nmeas]),
 *     then per instance: meas[nmeas] p0[nstate]
 *   "relaxed": the stopping rule bench.py uses on the device (max_iterations=10,
 *   thresholds 1e-3/1e-5/1e-5); default is the reference's stock
 *   parameters.
 *   "latency": instead of one pass over all instances (throughput), solve
 *   instance 0 repeatedly and report microseconds per solve.
 *
 * Prints one JSON line.
 *
 * Threading: an OpenMP parallel-for over instances. Each solve allocates
 * its own context and the vnlog/debug statics are untouched with debug
 * off, so the library is re-entrant in this configuration.
 */
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#ifdef _OPENMP
#include <omp.h>
#endif

#include <dogleg.h>

static const double P_TRUE_QS[6] = {1.0, 2.0, 3.0, 4.0, 5.0, 6.0};
static const double P_TRUE_CF[3] = {2.0, -1.5, 0.5};

typedef struct
{
    int           problem;     /* 0 = quadratic surface, 1 = curve fit */
    int           nstate, nmeas;
    const double* meas;
    const double* aux;         /* qs: gx then gy; cf: t */
    double*       scratch;     /* nmeas + nmeas*nstate, for products mode */
    long          n_evals;
} instance_t;

static void eval_residuals_jacobian(const double* p, const instance_t* in,
                                    double* x, double* J)
{
    const int nmeas = in->nmeas, nstate = in->nstate;
    if (in->problem == 0)
    {
        const double* gx = in->aux;
        const double* gy = in->aux + nmeas;
        for (int i = 0; i < nmeas; i++)
        {
            const double X = gx[i], Y = gy[i];
            x[i] = p[0]*p[1]*X*X + p[1]*p[2]*Y*Y + p[2]*X*Y
                 + p[3]*X + p[4]*Y + p[5]
                 - in->meas[i];
            double* row = &J[(long)i * nstate];
            row[0] = p[1]*X*X;
            row[1] = p[0]*X*X + p[2]*Y*Y;
            row[2] = p[1]*Y*Y + X*Y;
            row[3] = X;
            row[4] = Y;
            row[5] = 1.0;
        }
    }
    else
    {
        const double* t = in->aux;
        for (int i = 0; i < nmeas; i++)
        {
            const double e = exp(p[1] * t[i]);
            x[i] = p[0]*e + p[2] - in->meas[i];
            double* row = &J[(long)i * nstate];
            row[0] = e;
            row[1] = p[0] * t[i] * e;
            row[2] = 1.0;
        }
    }
}

static void cb_dense(const double* p, double* x, double* J, void* cookie)
{
    instance_t* in = (instance_t*)cookie;
    in->n_evals++;
    eval_residuals_jacobian(p, in, x, J);
}

/* products mode: the user reduces over measurements themselves (unpacked
   full-square JtJ layout: JtJ_packed=0). */
static void cb_products(const double* p, double* norm2x, double* xtJ,
                        double* JtJ, void* cookie)
{
    instance_t* in = (instance_t*)cookie;
    in->n_evals++;
    const int nmeas = in->nmeas, nstate = in->nstate;
    double* x = in->scratch;
    double* J = in->scratch + nmeas;
    eval_residuals_jacobian(p, in, x, J);

    double n2 = 0.0;
    for (int i = 0; i < nmeas; i++) n2 += x[i] * x[i];
    *norm2x = n2;

    for (int k = 0; k < nstate; k++)
    {
        double acc = 0.0;
        for (int i = 0; i < nmeas; i++) acc += J[(long)i*nstate + k] * x[i];
        xtJ[k] = acc;
    }
    for (int a = 0; a < nstate; a++)
        for (int b = 0; b < nstate; b++)
        {
            double acc = 0.0;
            for (int i = 0; i < nmeas; i++)
                acc += J[(long)i*nstate + a] * J[(long)i*nstate + b];
            JtJ[a*nstate + b] = acc;
        }
}

static double now_s(void)
{
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

/* ---- problem 2: grid MRF through the sparse path --------------------- */

typedef struct
{
    int           n_nodes, n_edges, b;
    const double* edges;    /* (n_edges, 2) as doubles (u, v), u < v */
    const double* z_prior;  /* (n_nodes * b) */
    const double* z_edge;   /* (n_edges * b) */
    const double* mix;      /* dense coupling: (n_edges, b, b) M_e, or
                               NULL for the diagonal coupling */
    double        sw_prior, sw_edge; /* sqrt weights */
    long          n_evals;
} grid_t;

/* residuals x and Jt (CSC, Nstate x Nmeas): prior rows then edge rows,
 * matching grid_mrf.make_grid_mrf's measurement order. Edge residual
 * r_(uv,k) = sw_e ((M_e p_v)_k - p_u_k - z_uv_k), M_e = I for diagonal
 * coupling. The pattern is static (the problem is linear); columns are
 * sorted (u < v). */
static void cb_grid(const double* p, double* x, cholmod_sparse* Jt,
                    void* cookie)
{
    grid_t* g = (grid_t*)cookie;
    g->n_evals++;
    const int b = g->b, n_nodes = g->n_nodes, n_edges = g->n_edges;
    int*    Jp = Jt->p;
    int*    Ji = Jt->i;
    double* Jx = Jt->x;
    long col = 0, w = 0;
    for (int v = 0; v < n_nodes; v++)
        for (int k = 0; k < b; k++)
        {
            x[col] = g->sw_prior * (p[v*b + k] - g->z_prior[v*b + k]);
            Jp[col] = (int)w;
            Ji[w]   = v*b + k;
            Jx[w++] = g->sw_prior;
            col++;
        }
    for (int e = 0; e < n_edges; e++)
    {
        const int u = (int)g->edges[2*e], v = (int)g->edges[2*e + 1];
        const double* M = g->mix ? &g->mix[(long)e*b*b] : NULL;
        for (int k = 0; k < b; k++)
        {
            double pv = 0.0;
            if (M)
                for (int c = 0; c < b; c++) pv += M[k*b + c] * p[v*b + c];
            else
                pv = p[v*b + k];
            x[col] = g->sw_edge * (pv - p[u*b + k] - g->z_edge[e*b + k]);
            Jp[col] = (int)w;
            Ji[w]   = u*b + k;
            Jx[w++] = -g->sw_edge;
            if (M)
                for (int c = 0; c < b; c++)
                {
                    Ji[w]   = v*b + c;
                    Jx[w++] = g->sw_edge * M[k*b + c];
                }
            else
            {
                Ji[w]   = v*b + k;
                Jx[w++] = g->sw_edge;
            }
            col++;
        }
    }
    Jp[col] = (int)w;
}

static int run_grid(FILE* f, int64_t nstate, int64_t nmeas,
                    const dogleg_parameters2_t* prm, long reps)
{
    double sub[6];
    if (fread(sub, sizeof(double), 6, f) != 6)
    { fprintf(stderr, "short grid subheader\n"); return 2; }
    grid_t g;
    g.n_nodes  = (int)sub[0];
    g.n_edges  = (int)sub[1];
    g.b        = (int)sub[2];
    g.sw_prior = sqrt(sub[3]);
    g.sw_edge  = sqrt(sub[4]);
    const int dense_coupling = (int)sub[5];
    g.n_evals  = 0;
    const size_t ne = (size_t)g.n_edges, nn = (size_t)g.n_nodes;
    double* edges   = malloc(sizeof(double) * 2 * ne);
    double* z_prior = malloc(sizeof(double) * nn * g.b);
    double* z_edge  = malloc(sizeof(double) * ne * g.b);
    double* mix     = dense_coupling
        ? malloc(sizeof(double) * ne * g.b * g.b) : NULL;
    double* p       = calloc((size_t)nstate, sizeof(double));
    if (fread(edges, sizeof(double), 2*ne, f) != 2*ne ||
        fread(z_prior, sizeof(double), nn*g.b, f) != nn*g.b ||
        fread(z_edge, sizeof(double), ne*g.b, f) != ne*g.b ||
        (dense_coupling &&
         fread(mix, sizeof(double), ne*g.b*g.b, f) != ne*g.b*g.b))
    { fprintf(stderr, "short grid data\n"); return 2; }
    fclose(f);
    g.edges = edges; g.z_prior = z_prior; g.z_edge = z_edge; g.mix = mix;

    const unsigned NJnnz = (unsigned)(nn*g.b
                                      + (dense_coupling
                                         ? ne*g.b*(1 + (size_t)g.b)
                                         : 2*ne*g.b));
    double norm2 = 0.0;
    const double t0 = now_s();
    for (long r = 0; r < reps; r++)
    {
        memset(p, 0, sizeof(double) * (size_t)nstate);
        norm2 = dogleg_optimize2(p, (unsigned)nstate, (unsigned)nmeas,
                                 NJnnz, cb_grid, &g, prm, NULL);
    }
    const double wall = now_s() - t0;
    printf("{\"problem\": 2, \"mode\": \"sparse-latency\", "
           "\"coupling\": \"%s\", ", dense_coupling ? "dense" : "diag");
    printf("\"nstate\": %lld, \"nmeas\": %lld, \"reps\": %ld, "
           "\"wall_s\": %.6f, \"latency_ms\": %.3f, "
           "\"mean_evals\": %.3f, \"norm2_x\": %.10e}\n",
           (long long)nstate, (long long)nmeas, reps, wall,
           1e3 * wall / (double)reps,
           (double)g.n_evals / (double)reps, norm2);
    free(edges); free(z_prior); free(z_edge); free(mix); free(p);
    return 0;
}

static void solve_instance(instance_t* in, double* p,
                           const dogleg_parameters2_t* prm, int products)
{
    if (products)
        dogleg_optimize_dense_products(p, in->nstate,
                                       cb_products, in, prm, NULL);
    else
        dogleg_optimize_dense2(p, in->nstate, in->nmeas,
                               cb_dense, in, prm, NULL);
}

int main(int argc, char** argv)
{
    if (argc < 4)
    {
        fprintf(stderr, "usage: %s instances.bin dense|products nthreads"
                        " [relaxed] [latency]\n", argv[0]);
        return 2;
    }
    const char* path     = argv[1];
    const int   products = strcmp(argv[2], "products") == 0;
    const int   nthreads = atoi(argv[3]);
    int relaxed = 0, latency = 0;
    for (int a = 4; a < argc; a++)
    {
        if (strcmp(argv[a], "relaxed") == 0) relaxed = 1;
        if (strcmp(argv[a], "latency") == 0) latency = 1;
    }

    FILE* f = fopen(path, "rb");
    if (!f) { perror("fopen"); return 2; }
    int64_t hdr[4];
    if (fread(hdr, sizeof(int64_t), 4, f) != 4)
    { fprintf(stderr, "short header\n"); return 2; }
    const int  problem = (int)hdr[0];
    const int  nstate  = (int)hdr[1];
    const int  nmeas   = (int)hdr[2];
    const long n       = (long)hdr[3];
    const int  naux    = problem == 0 ? 2 * nmeas : nmeas;
    if (problem < 0 || problem > 2 || nstate <= 0 || nmeas <= 0 || n <= 0)
    { fprintf(stderr, "bad header\n"); return 2; }

    if (problem == 2)
    {
        dogleg_parameters2_t gprm;
        dogleg_getDefaultParameters(&gprm);
        gprm.dogleg_debug = 0;
        if (relaxed)
        {
            gprm.max_iterations        = 10;
            gprm.Jt_x_threshold        = 1e-3;
            gprm.update_threshold      = 1e-5;
            gprm.trustregion_threshold = 1e-5;
        }
        /* n in the header carries the rep count for the latency loop */
        return run_grid(f, nstate, nmeas, &gprm, n);
    }

    double* aux  = malloc(sizeof(double) * (size_t)naux);
    double* meas = malloc(sizeof(double) * (size_t)n * nmeas);
    double* p0   = malloc(sizeof(double) * (size_t)n * nstate);
    double* p    = malloc(sizeof(double) * (size_t)n * nstate);
    long*   ev   = calloc((size_t)n, sizeof(long));
    if (fread(aux, sizeof(double), (size_t)naux, f) != (size_t)naux)
    { fprintf(stderr, "short aux read\n"); return 2; }
    for (long i = 0; i < n; i++)
        if (fread(&meas[i*nmeas], sizeof(double), (size_t)nmeas, f)
                != (size_t)nmeas ||
            fread(&p0[i*nstate], sizeof(double), (size_t)nstate, f)
                != (size_t)nstate)
        { fprintf(stderr, "short read at instance %ld\n", i); return 2; }
    fclose(f);

    dogleg_parameters2_t prm;
    dogleg_getDefaultParameters(&prm);
    prm.dogleg_debug = 0;
    if (relaxed)
    {
        /* the stopping rule bench.py uses for the f32 device solves */
        prm.max_iterations        = 10;
        prm.Jt_x_threshold        = 1e-3;
        prm.update_threshold      = 1e-5;
        prm.trustregion_threshold = 1e-5;
    }

#ifdef _OPENMP
    omp_set_num_threads(nthreads > 0 ? nthreads : 1);
#endif

    const double* p_true = problem == 0 ? P_TRUE_QS : P_TRUE_CF;
    double wall;
    long   n_solves, total_evals = 0, n_ok = 0;

    if (latency)
    {
        /* single-solve latency: re-solve instance 0 back to back */
        const long reps = 2000;
        instance_t in = { problem, nstate, nmeas, &meas[0], aux,
                          malloc(sizeof(double) * (size_t)nmeas
                                 * (size_t)(1 + nstate)), 0 };
        const double t0 = now_s();
        for (long r = 0; r < reps; r++)
        {
            memcpy(p, p0, sizeof(double) * (size_t)nstate);
            solve_instance(&in, p, &prm, products);
        }
        wall = now_s() - t0;
        n_solves = reps;
        total_evals = in.n_evals;
        int ok = 1;
        for (int k = 0; k < nstate; k++)
            if (fabs(p[k] - p_true[k]) >= 0.2) ok = 0;
        n_ok = ok ? reps : 0;
        free(in.scratch);
    }
    else
    {
        memcpy(p, p0, sizeof(double) * (size_t)n * nstate);
        const double t0 = now_s();
#ifdef _OPENMP
#pragma omp parallel
#endif
        {
            double* scratch = malloc(sizeof(double) * (size_t)nmeas
                                     * (size_t)(1 + nstate));
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
            for (long i = 0; i < n; i++)
            {
                instance_t in = { problem, nstate, nmeas, &meas[i*nmeas],
                                  aux, scratch, 0 };
                solve_instance(&in, &p[i*nstate], &prm, products);
                ev[i] = in.n_evals;
            }
            free(scratch);
        }
        wall = now_s() - t0;
        n_solves = n;
        for (long i = 0; i < n; i++)
        {
            int ok = 1;
            for (int k = 0; k < nstate; k++)
                if (fabs(p[i*nstate + k] - p_true[k]) >= 0.2) ok = 0;
            n_ok += ok;
            total_evals += ev[i];
        }
    }

    printf("{\"problem\": %d, \"mode\": \"%s%s\", \"threads\": %d, "
           "\"relaxed\": %d, \"n\": %ld, \"wall_s\": %.6f, "
           "\"solves_per_s\": %.2f, \"latency_us\": %.3f, "
           "\"mean_evals\": %.3f, \"recovered_frac\": %.4f}\n",
           problem, products ? "products" : "dense",
           latency ? "-latency" : "", nthreads, relaxed, n_solves, wall,
           (double)n_solves / wall, 1e6 * wall / (double)n_solves,
           (double)total_evals / (double)n_solves,
           (double)n_ok / (double)n_solves);
    free(aux); free(meas); free(p0); free(p); free(ev);
    return 0;
}
