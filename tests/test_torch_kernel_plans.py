"""Launch plans and C interfaces of the port's CUDA kernels, checked without
a GPU: the wrappers' pure ``plan`` functions (grid, threads, dynamic shared
bytes, regime) at the flagship's and the density model's shapes and at the
edges, and the sources under csrc/ against what the wrappers name."""

import ctypes
import re

import pytest
import torch

from waveflow_tpu_torch.ops import (cuda_build, cuda_jet, cuda_sampler,
                                    cuda_spline)

torch.set_num_threads(2)

SMEM_LIMIT = 232_448          # dynamic shared bytes a block may use on an H100
N_SM = 132

# (n_bases, n_mesh): the flagship's squared-amplitude table (K1), the density
# model's M-spline prior (K2), and small tables
SAMPLER_TABLES = [(28, 2000), (16, 2000), (12, 300), (7, 2), (20, 2049)]
# (n_cells, ncoef, n_out): the flagship's I-spline and OB jets, a low degree
JET_SHAPES = [(22, 8, 116), (22, 8, 112), (11, 6, 56), (1, 1, 4)]
SIZES = [1, 2, 3, 31, 255, 256, 257, 300, 512, 528, 1000, 4097, 19_999,
         20_000, 65_535, 65_536, 131_071, 131_072, 1_048_576]


@pytest.mark.parametrize('n_bases,n_mesh', SAMPLER_TABLES)
@pytest.mark.parametrize('B', SIZES)
def test_sampler_plan_fits_and_covers(B, n_bases, n_mesh):
    """Every accepted shape fits the block's shared memory, launches at
    least one block and no more blocks than groups or SMs, with the threads
    of its group size."""
    p = cuda_sampler.plan(B, n_bases, n_mesh)
    G = p.group
    assert p.regime == 'shared' and G in cuda_sampler.WALKERS_PER_BLOCK
    assert p.threads == cuda_sampler.WALKERS_PER_BLOCK[G]
    assert p.smem_bytes == cuda_sampler.smem_bytes(n_bases, n_mesh, G)
    assert 4 * n_bases * n_mesh < p.smem_bytes <= SMEM_LIMIT
    assert 1 <= p.grid <= min(-(-B // G), N_SM)
    assert G * n_bases <= cuda_sampler.PREFETCH_REGISTERS * p.threads


@pytest.mark.parametrize('B,G', [(1, 2), (256, 2), (300, 4), (528, 4),
                                 (1024, 8), (20_000, 8), (65_536, 8)])
def test_sampler_plan_group_size(B, G):
    """Small groups while they spread over idle SMs, groups of 8 once every
    SM is busy; a forced group size is taken as given."""
    assert cuda_sampler.plan(B, 28, 2000).group == G
    for forced in cuda_sampler.WALKERS_PER_BLOCK:
        p = cuda_sampler.plan(B, 28, 2000, walkers_per_block=forced)
        assert p.group == forced and 1 <= p.grid <= -(-B // forced)


@pytest.mark.parametrize('B', [1, 257, 65_536])
@pytest.mark.parametrize('n_bases', [29, 45, 64, 128])
def test_sampler_plan_streams_a_table_that_does_not_fit(B, n_bases):
    """A table above the block's shared memory is streamed by the same
    kernel — said in the plan, never silent: groups of 8, shared memory for
    the scratch alone."""
    assert 4 * n_bases * 2000 > SMEM_LIMIT - 8192
    p = cuda_sampler.plan(B, n_bases, 2000)
    assert (p.regime, p.group, p.threads) == ('streamed', 8, 512)
    assert p.smem_bytes == cuda_sampler.smem_bytes(n_bases, 2000, 8, False)
    assert p.smem_bytes < 4 * 2000 * n_bases and p.smem_bytes <= SMEM_LIMIT
    assert 1 <= p.grid <= min(-(-B // 8), N_SM)


@pytest.mark.parametrize('n_bases,n_mesh,what', [
    (129, 2000, 'shared memory'),     # too wide even for a streamed table
    (500, 2000, 'shared memory'),
    (28, 2050, 'n_mesh'),             # more cells than 256 threads x 8
    (28, 1, 'n_mesh'),
    (0, 2000, 'n_bases'),
])
def test_sampler_plan_refuses(n_bases, n_mesh, what):
    """A table the kernel cannot take at all, or a mesh above its cells,
    raises ValueError naming the limit — never another path."""
    with pytest.raises(ValueError, match=what) as err:
        cuda_sampler.plan(256, n_bases, n_mesh)
    if what == 'shared memory':
        assert str(SMEM_LIMIT) in str(err.value)


def test_sampler_plan_follows_the_device_limit():
    """A smaller shared-memory limit (another card) streams the flagship
    table, and refuses it where not even the scratch fits; a forced group
    size must be one that fits in shared memory; B = 0 is refused."""
    assert cuda_sampler.plan(256, 28, 2000, smem_limit=100_000).regime \
        == 'streamed'
    with pytest.raises(ValueError, match='2000'):
        cuda_sampler.plan(256, 28, 2000, smem_limit=2000)
    p = cuda_sampler.plan(256, 16, 1000, smem_limit=100_000)
    assert p.regime == 'shared' and p.smem_bytes <= 100_000
    with pytest.raises(ValueError, match='walkers_per_block'):
        cuda_sampler.plan(256, 28, 2000, walkers_per_block=3)
    with pytest.raises(ValueError, match='walkers_per_block'):
        cuda_sampler.plan(256, 45, 2000, walkers_per_block=8)
    with pytest.raises(ValueError):
        cuda_sampler.plan(0, 28, 2000)


@pytest.mark.parametrize('n_cells,ncoef,n_out', JET_SHAPES)
@pytest.mark.parametrize('R', SIZES)
def test_jet_plan_fits_and_covers(R, n_cells, ncoef, n_out):
    """Both regimes give one warp per site: the direct grid covers R
    exactly, the staged one never exceeds the work or two blocks per SM and
    holds A_jet plus its mbarrier in shared memory."""
    p = cuda_jet.plan(R, n_cells, ncoef, n_out)
    assert p.grid >= 1
    if p.regime == 'direct':
        warps = cuda_jet.DIRECT_THREADS // 32
        assert (p.threads, p.smem_bytes) == (cuda_jet.DIRECT_THREADS, 0)
        assert (p.grid - 1) * warps < R <= p.grid * warps
    else:
        assert p.regime == 'staged' and R >= cuda_jet.STAGED_MIN_SITES
        assert p.threads == cuda_jet.STAGED_THREADS
        assert p.smem_bytes == 4 * n_cells * ncoef * n_out + 16 <= SMEM_LIMIT
        per_pass = cuda_jet.STAGED_THREADS // 32 * cuda_jet.STAGED_SITES
        assert p.grid <= min(2 * N_SM, -(-R // per_pass))


@pytest.mark.parametrize('n_cells,ncoef,n_out', JET_SHAPES)
def test_jet_switch_is_monotone_in_R(n_cells, ncoef, n_out):
    """Once a size is staged, every larger size is; the switch sits at
    STAGED_MIN_SITES."""
    regimes = [cuda_jet.plan(R, n_cells, ncoef, n_out).regime
               for R in sorted(SIZES + [cuda_jet.STAGED_MIN_SITES - 1,
                                        cuda_jet.STAGED_MIN_SITES])]
    first = regimes.index('staged')
    assert set(regimes[:first]) == {'direct'}
    assert set(regimes[first:]) == {'staged'}
    assert cuda_jet.plan(cuda_jet.STAGED_MIN_SITES - 1, n_cells, ncoef,
                         n_out).regime == 'direct'
    assert cuda_jet.plan(cuda_jet.STAGED_MIN_SITES, n_cells, ncoef,
                         n_out).regime == 'staged'


def test_jet_plan_too_large_for_staging_stays_direct():
    """An A_jet above the block's shared memory is served by the direct
    regime at every R (the same kernel, from L1/L2); forcing it staged
    raises with the limit; malformed shapes are refused."""
    big = (200, 10, 200)                            # 1.6 MB
    assert cuda_jet.plan(1_048_576, *big).regime == 'direct'
    with pytest.raises(ValueError, match=str(SMEM_LIMIT)):
        cuda_jet.plan(1_048_576, *big, regime='staged')
    assert cuda_jet.plan(512, 22, 8, 116, regime='staged').regime == 'staged'
    for bad in [(0, 22, 8, 116), (512, 22, 8, 115), (512, 0, 8, 116),
                (512, 22, 0, 116), (512, 22, 8, 0)]:
        with pytest.raises(ValueError):
            cuda_jet.plan(*bad)
    with pytest.raises(ValueError, match='regime'):
        cuda_jet.plan(512, 22, 8, 116, regime='tiled')


@pytest.mark.parametrize('backward', [False, True])
@pytest.mark.parametrize('n_bases', [5, 16, 29, 64])
@pytest.mark.parametrize('N', [1, 31, 32, 33, 512, 40_000, 40_001])
def test_spline_plan_covers(N, n_bases, backward):
    """K4, forward and backward: a power of two of lanes that divides the
    warp shares a row, 4 bases per lane and load where they fit; a block
    covers 256 / lanes rows; the grid covers N and never exceeds the
    work; no shared memory."""
    p = cuda_spline.plan(N, n_bases, backward)
    lanes = p.group
    assert (p.threads, p.smem_bytes) == (cuda_spline.THREADS, 0)
    assert p.smem_bytes <= SMEM_LIMIT
    assert p.regime == ('backward' if backward else 'forward')
    assert 32 % lanes == 0
    chunks = -(-n_bases // cuda_spline.CHUNK)
    assert lanes == cuda_spline.lanes_per_row(n_bases)
    assert lanes >= chunks or lanes == 32
    assert lanes < 2 * chunks or lanes == 1
    per_block = cuda_spline.THREADS // lanes
    assert p.grid >= 1 and (p.grid - 1) * per_block < N <= p.grid * per_block


@pytest.mark.parametrize('n_bases,lanes', [(1, 1), (4, 1), (5, 2), (16, 4),
                                           (28, 8), (29, 8), (64, 16),
                                           (128, 32), (129, 32), (500, 32)])
def test_spline_lanes_per_row(n_bases, lanes):
    """Lanes per row from n_bases: the density model's 16 bases take 4."""
    assert cuda_spline.lanes_per_row(n_bases) == lanes


@pytest.mark.parametrize('lanes', [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize('N', [1, 513, 40_001])
def test_spline_plan_forced(lanes, N):
    """Forced lanes per row (measurements) are taken as given and still
    cover the work."""
    for backward in (False, True):
        p = cuda_spline.plan(N, 16, backward, lanes)
        per_block = 256 // lanes
        assert p.group == lanes
        assert (p.grid - 1) * per_block < N <= p.grid * per_block


def test_spline_plan_refuses():
    for bad in [(0, 16), (512, 0)]:
        with pytest.raises(ValueError):
            cuda_spline.plan(*bad)
    for lanes in (0, 3, 64):
        with pytest.raises(ValueError, match='lanes'):
            cuda_spline.plan(512, 16, False, lanes)


@pytest.mark.parametrize('terms,components', [(15, 4), (9, 4), (1, 1),
                                               (16, 4)])
@pytest.mark.parametrize('n_bases', [7, 28, 29])
@pytest.mark.parametrize('N', [1, 31, 512, 513, 8192, 40_000, 40_001])
def test_spline_jet_plan_covers(N, n_bases, terms, components):
    """K4's jet entry: the forward kernel's lanes per row (so each term
    sums as the per-call entries do) in blocks of JET_BLOCK threads that
    cover N and never exceed the work; no shared memory."""
    p = cuda_spline.plan_jet(N, n_bases, terms, components, 4)
    assert p.group == cuda_spline.lanes_per_row(n_bases)
    assert (p.threads, p.smem_bytes, p.regime) == (cuda_spline.JET_BLOCK, 0,
                                                   'jet')
    assert p.threads in cuda_spline.JET_THREADS and p.threads % 32 == 0
    per_block = p.threads // p.group
    assert (p.grid - 1) * per_block < N <= p.grid * per_block


@pytest.mark.parametrize('threads', [32, 64, 128, 256])
@pytest.mark.parametrize('N', [1, 513, 40_001])
def test_spline_jet_plan_forced(threads, N):
    """A forced block size (measurements) is taken as given and still
    covers the work, at the flagship I-spline tables' 29 bases."""
    p = cuda_spline.plan_jet(N, 29, 15, 4, 4, threads)
    per_block = threads // 8
    assert (p.threads, p.group) == (threads, 8)
    assert (p.grid - 1) * per_block < N <= p.grid * per_block


def test_spline_jet_plan_refuses():
    """Beyond the kernel's limits the plan raises, naming what is over:
    more terms, components or tabulated orders than one launch takes, a
    block size it does not take, an empty shape."""
    with pytest.raises(ValueError, match='terms'):
        cuda_spline.plan_jet(512, 29, cuda_spline.JET_TERMS + 1, 4, 4)
    with pytest.raises(ValueError, match='components'):
        cuda_spline.plan_jet(512, 29, 15, cuda_spline.JET_COMPONENTS + 1, 4)
    with pytest.raises(ValueError, match='orders'):
        cuda_spline.plan_jet(512, 29, 15, 4, cuda_spline.JET_ORDERS + 1)
    for threads in (16, 48, 512):
        with pytest.raises(ValueError, match='threads'):
            cuda_spline.plan_jet(512, 29, 15, 4, 4, threads)
    for bad in [(0, 29, 15, 4, 4), (512, 0, 15, 4, 4), (512, 29, 0, 4, 4),
                (512, 29, 15, 0, 4)]:
        with pytest.raises(ValueError):
            cuda_spline.plan_jet(*bad)


def test_spline_jet_wrapper_refuses_a_cpu_tensor():
    """The jet entry's kernel wrapper raises on CPU tensors (no plain
    fallback inside it); the dispatching wrapper runs the plain version
    there, one output per term."""
    tables, slopes = torch.rand(2, 10, 5), torch.rand(2, 10, 5)
    records = torch.as_tensor(cuda_spline.cell_records(tables.numpy()))
    comps, x = [torch.rand(8, 5)], torch.rand(8)
    with pytest.raises(ValueError, match='CUDA'):
        cuda_spline.spline_eval_jet_cuda(records, comps, x, [(0, 0, False)],
                                         5)
    out = cuda_spline.spline_eval_jet(tables, slopes, records, comps, x,
                                      [(0, 0, False), (0, 1, True)])
    assert [o.shape for o in out] == [(8,), (8,)]


LINEAR_TABLES = [(16, 2000), (12, 300), (7, 2), (20, 2049), (28, 2000)]


@pytest.mark.parametrize('n_bases,n_mesh', LINEAR_TABLES)
@pytest.mark.parametrize('B', SIZES)
def test_linear_sampler_plan_fits_and_covers(B, n_bases, n_mesh):
    """K2's plans (kind 'linear', costs per group measured at 16 bases): a
    listed group with its threads, table and scratch inside the block's
    shared memory, a grid of at least one block and no more than the groups
    or the SMs."""
    p = cuda_sampler.plan(B, n_bases, n_mesh, kind='linear')
    G = p.group
    assert p.regime == 'shared' and G in cuda_sampler.WALKERS_PER_BLOCK
    assert p.threads == cuda_sampler.WALKERS_PER_BLOCK[G]
    assert p.smem_bytes == cuda_sampler.smem_bytes(n_bases, n_mesh, G)
    assert 4 * n_bases * n_mesh < p.smem_bytes <= SMEM_LIMIT
    assert 1 <= p.grid <= min(-(-B // G), N_SM)
    assert G * n_bases <= cuda_sampler.PREFETCH_REGISTERS * p.threads


def test_linear_sampler_plan_group_size():
    """At the density model's table every listed group fits and a forced
    one is taken as given; small groups while they spread over idle SMs,
    groups of 8 once every SM is busy; both kinds have a cost for every
    group; an unknown kind is refused."""
    for forced, threads in cuda_sampler.WALKERS_PER_BLOCK.items():
        p = cuda_sampler.plan(20_000, 16, 2000, walkers_per_block=forced,
                              kind='linear')
        assert (p.group, p.threads) == (forced, threads)
        assert p.smem_bytes <= SMEM_LIMIT
    groups = [cuda_sampler.plan(B, 16, 2000, kind='linear').group
              for B in (1, 256, 1000, 4096, 20_000, 65_536)]
    assert groups == sorted(groups) and (groups[0], groups[-1]) == (2, 8)
    assert cuda_sampler.plan(20_000, 16, 2000, kind='linear').group == 8
    for kind, cost in cuda_sampler.GROUP_COST.items():
        assert set(cost) == set(cuda_sampler.WALKERS_PER_BLOCK), kind
        # a larger group costs more in all, less per walker
        assert cost[2] < cost[4] < cost[8]
        assert cost[2] / 2 > cost[4] / 4 > cost[8] / 8
    assert cuda_sampler.plan(256, 45, 2000, kind='linear').regime == 'streamed'
    with pytest.raises(ValueError, match='kind'):
        cuda_sampler.plan(256, 16, 2000, kind='cubic')


def test_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the kernel wrappers raise; only the dispatching
    functions take the plain versions."""
    x = torch.rand(8)
    A = torch.rand(22 * 8, 116)
    with pytest.raises(ValueError, match='CUDA'):
        cuda_jet.basis_jet_cuda(x, A, 22, 8)
    with pytest.raises(ValueError, match='CUDA'):
        cuda_spline.spline_eval_cuda(torch.rand(10, 4), torch.rand(8, 4), x)
    with pytest.raises(ValueError, match='CUDA'):
        cuda_spline.spline_eval_bwd_cuda(torch.rand(10, 4), torch.rand(10, 4),
                                         torch.rand(8, 4), x, x)
    assert cuda_jet.basis_jet(x, A, 22, 8).shape == (8, 116)


def _extern_c(source: str) -> set:
    return set(re.findall(r'extern\s+"C"\s+[\w\s\*]+?\b(\w+)\s*\(', source))


ENTRY_POINTS = {
    'basis_jet': {'basis_jet_launch', 'basis_jet_init',
                  'basis_jet_error_string'},
    'sampler': {'sampler_launch', 'sampler_linear_launch', 'sampler_init',
                'sampler_error_string'},
    'spline_eval': {'spline_eval_launch', 'spline_eval_pair_launch',
                    'spline_eval_bwd_launch', 'spline_eval_jet_launch',
                    'spline_eval_bwd_jet_launch',
                    'spline_eval_error_string'},
}


@pytest.mark.parametrize('name', sorted(ENTRY_POINTS))
def test_entry_points_are_extern_c(name):
    """Every C entry point a wrapper names is declared extern "C" in its
    source, and the source declares no other."""
    source = (cuda_build.CSRC_DIR / f'{name}.cu').read_text()
    assert _extern_c(source) == ENTRY_POINTS[name]


@pytest.mark.parametrize('module,name', [(cuda_jet, 'basis_jet'),
                                         (cuda_sampler, 'sampler'),
                                         (cuda_spline, 'spline_eval')])
def test_wrappers_bind_the_declared_entry_points(module, name, monkeypatch):
    """A wrapper's signatures name exactly the entry points its source
    declares, every pointer as a pointer-sized argument, and binding sets
    them once."""
    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self):
            self.seen = {}

        def __getattr__(self, entry):
            return self.seen.setdefault(entry, Fn())

    lib, loads = Lib(), []
    monkeypatch.setattr(cuda_build, 'load',
                        lambda n: loads.append(n) or lib)
    monkeypatch.setattr(cuda_build, '_BOUND', {})
    assert set(module.SIGNATURES) == ENTRY_POINTS[name]
    assert cuda_build.bind(name, module.SIGNATURES) is lib
    assert cuda_build.bind(name, module.SIGNATURES) is lib
    assert loads == [name] and set(lib.seen) == ENTRY_POINTS[name]
    launch = lib.seen[f'{name}_launch']
    assert launch.restype is ctypes.c_int
    assert launch.argtypes[0] is ctypes.c_void_p
    assert launch.argtypes[-1] is ctypes.c_void_p          # the stream
    assert lib.seen[f'{name}_error_string'].restype is ctypes.c_char_p
    for entry, fn in lib.seen.items():
        if entry.endswith('_launch'):           # every launcher of the source
            assert fn.restype is ctypes.c_int
            assert fn.argtypes[0] is fn.argtypes[-1] is ctypes.c_void_p


def test_kernels_match_the_sources(tmp_path, monkeypatch):
    """cuda_build.KERNELS names exactly the .cu files under csrc/, and a
    library's name changes when its source or a header beside it does."""
    sources = {p.stem for p in cuda_build.CSRC_DIR.glob('*.cu')}
    assert set(cuda_build.KERNELS) == sources == set(ENTRY_POINTS)
    for path in cuda_build.CSRC_DIR.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(cuda_build, 'CSRC_DIR', tmp_path)
    before = cuda_build.library_path('sampler')
    assert before.parent == cuda_build.BUILD_DIR
    headers = sorted(tmp_path.glob('*.cuh'))
    assert headers, "the bulk-copy header is part of the build"
    with open(headers[0], 'a') as f:
        f.write('// edited\n')
    after_header = cuda_build.library_path('sampler')
    with open(tmp_path / 'sampler.cu', 'a') as f:
        f.write('// edited\n')
    assert len({before, after_header, cuda_build.library_path('sampler')}) == 3


def test_plan_constants_match_the_sources():
    """The constants the Python plans use are the kernels' own."""
    jet = (cuda_build.CSRC_DIR / 'basis_jet.cu').read_text()
    sampler = (cuda_build.CSRC_DIR / 'sampler.cu').read_text()
    spline = (cuda_build.CSRC_DIR / 'spline_eval.cu').read_text()

    def const(source, name):
        return int(re.search(rf'constexpr int {name} = (\d+);', source).group(1))

    assert const(jet, 'DIRECT_THREADS') == cuda_jet.DIRECT_THREADS
    assert const(jet, 'STAGED_THREADS') == cuda_jet.STAGED_THREADS
    assert const(jet, 'SITES') == cuda_jet.STAGED_SITES
    assert const(sampler, 'HALF_THREADS') == cuda_sampler.HALF_THREADS
    assert const(sampler, 'CPT') == cuda_sampler.CELLS_PER_THREAD
    assert const(sampler, 'CREG') == cuda_sampler.PREFETCH_REGISTERS
    assert const(sampler, 'RING') == cuda_sampler.RING
    assert const(spline, 'THREADS') == cuda_spline.THREADS
    assert const(spline, 'CHUNK') == cuda_spline.CHUNK
    assert const(spline, 'JET_TERMS') == cuda_spline.JET_TERMS
    assert const(spline, 'JET_COMPONENTS') == cuda_spline.JET_COMPONENTS
    assert const(spline, 'JET_ORDERS') == cuda_spline.JET_ORDERS
    assert const(spline, 'JET_MAX_THREADS') == max(cuda_spline.JET_THREADS)
    # the group sizes the sampler's launcher switches over
    cases = {int(g) for g in re.findall(r'case (\d+):\n', sampler)}
    assert cases == set(cuda_sampler.WALKERS_PER_BLOCK)
