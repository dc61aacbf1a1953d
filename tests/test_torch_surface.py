"""The port's public surface against the JAX package's, on the CPU.

Every public name of a JAX module -- its top-level functions, classes
and upper-case constants, read from its source (a package's
``__init__`` also counts the names it imports) -- must have a
counterpart in the port module it maps to, and every public member of
a JAX class one in the port's class.  For the host tier (the namespace,
codecs, coders, models, utils, the native runtime and the host ``ops``
modules, which live in the port's ``host``), where both are callable the
port's leading parameters must be JAX's: the same names and kinds in
the same order, a default wherever JAX has one, and the same default
where it is a plain value.  Parameters the port adds after JAX's
(``native_body``, ``device``) must have defaults.

The device tier (``ops.jax_kernels``, the Pallas modules, the
``device_*`` modules and ``parallel``) is held to its names only: its
JAX functions take XLA's static shape arguments (``width``,
``chunk_len``, ``power_k``, ``alloc_impl``, ``interpret``) that the
port's kernels have no use for.  `EXCLUDED` lists each JAX name that has
no counterpart on purpose, with the reason; `SIGNATURES` each callable
whose parameters differ on purpose."""

import ast
import importlib
import inspect

import pytest
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

HOST = {
    'compressjs_tpu': 'compressjs_tpu_torch',
    'compressjs_tpu.ops.bwt': 'compressjs_tpu_torch.BWT',
    'compressjs_tpu.ops.mtf': 'compressjs_tpu_torch.host.mtf',
    'compressjs_tpu.ops.rle': 'compressjs_tpu_torch.host.rle',
    'compressjs_tpu.ops.huffman_stages':
        'compressjs_tpu_torch.host.huffman_stages',
    'compressjs_tpu.native': 'compressjs_tpu_torch.native',
    'compressjs_tpu.config': 'compressjs_tpu_torch.config',
    'compressjs_tpu.cli': 'compressjs_tpu_torch.cli',
    'compressjs_tpu.coders': 'compressjs_tpu_torch.coders',
    'compressjs_tpu.models': 'compressjs_tpu_torch.models',
    'compressjs_tpu.utils': 'compressjs_tpu_torch.utils',
}
HOST.update({'compressjs_tpu.utils.%s' % m: 'compressjs_tpu_torch.utils.%s' % m
             for m in ('crc32', 'freeze', 'stream', 'util')})
HOST.update({'compressjs_tpu.%s.%s' % (pkg, m):
             'compressjs_tpu_torch.host.%s' % m
             for pkg, mods in (
                 ('codecs', ('bzip2', 'bwtc', 'bwtcp', 'bwtcl', 'lzp3',
                             'lzjb', 'lzjbr', 'ppm', 'dmc', 'simple')),
                 ('coders', ('range_coder', 'dummy_range_coder', 'huffman',
                             'huffman_allocator')),
                 ('models', ('context1_model', 'deflate_distance_model',
                             'defsum_model', 'fenwick_model',
                             'log_distance_model', 'mtf_model',
                             'no_model')))
             for m in mods})

DEVICE = {
    'compressjs_tpu.ops.jax_kernels':
        ('compressjs_tpu_torch.ops.block_kernels',
         'compressjs_tpu_torch.ops.block_decode'),
    'compressjs_tpu.ops.pallas_kernels':
        ('compressjs_tpu_torch.ops.block_kernels',),
    'compressjs_tpu.ops.pallas_compose': ('compressjs_tpu_torch.ops.compose',),
}
DEVICE.update({'compressjs_tpu.ops.%s' % m:
               ('compressjs_tpu_torch.ops.%s' % m,)
               for m in ('device_entropy', 'device_huffman', 'device_coder',
                         'device_model', 'device_lane')})
DEVICE.update({'compressjs_tpu.parallel.%s' % m:
               ('compressjs_tpu_torch.parallel.%s' % m,)
               for m in ('mesh', 'hetero', 'pipeline', 'decode',
                         'sharded_sort', 'profiling')})

_PALLAS = 'the TPU tile shape of a Pallas kernel; the CUDA kernel has its own'
EXCLUDED = {
    ('compressjs_tpu.ops.jax_kernels', 'ORBIT_CURSORS'):
        'cursor count of the XLA orbit-doubling inverse BWT; the port '
        'walks LF chains by rank doubling (ops.block_decode)',
    ('compressjs_tpu.ops.jax_kernels', 'pack_cyclic_seed_keys'):
        'packs the XLA sort\'s seed keys into one word for lax.sort; the '
        'port seeds its ranks from four byte keys (_seed_ranks_start4)',
    ('compressjs_tpu.ops.pallas_kernels', 'LANES'): _PALLAS,
    ('compressjs_tpu.ops.pallas_kernels', 'SUBLANES'): _PALLAS,
    ('compressjs_tpu.ops.pallas_compose', 'LANES'): _PALLAS,
    ('compressjs_tpu.ops.pallas_kernels', 'mtf_chunks'):
        'the Pallas MTF kernel; csrc/mtf_scan.cu replaces it '
        '(ops.block_kernels.mtf_scan)',
    ('compressjs_tpu.ops.pallas_kernels', 'mtf_encode_pallas'):
        'the Pallas route of the MTF encode; the port has one route, the '
        'CUDA kernel (ops.block_kernels.mtf_encode)',
    ('compressjs_tpu.ops.device_entropy', 'alloc_lengths_dev'):
        'the XLA while-loop allocator; csrc/alloc_lengths.cu replaces it',
    ('compressjs_tpu.ops.device_entropy', 'alloc_lengths_pallas'):
        'the Pallas allocator kernel; csrc/alloc_lengths.cu replaces it',
    ('compressjs_tpu.ops.device_entropy', 'code_lengths_from_freqs_dev'):
        'one XLA table build; the port builds every table of a block in '
        'one launch (code_lengths_batch, cz_code_lengths)',
    ('compressjs_tpu.ops.device_entropy', 'payload_cap_bytes'):
        'the fixed payload cap of XLA\'s static shapes; the port sizes each '
        'payload from its bit count',
    ('compressjs_tpu.ops.device_huffman', 'CHASE_UNROLL'):
        'the unroll of the XLA selector chase; csrc/selector_chase.cu '
        'replaces it',
    ('compressjs_tpu.ops.device_coder', 'MASK32'):
        'uint32 wrap of the XLA coder scan; the port\'s coder is a CUDA '
        'kernel on 32-bit registers (csrc/fenwick_encode.cu)',
    ('compressjs_tpu.parallel.sharded_sort', 'AXIS'):
        'the shard_map mesh axis name; the port\'s mesh is a '
        'torch.distributed group',
    ('compressjs_tpu.parallel.profiling', 'HBM_PEAK_GBS'):
        'the TPU\'s memory rate; the port\'s bounds use the card\'s '
        '(chip_smoke.py)',
    ('compressjs_tpu.parallel.profiling', 'GATHER_PEAK_G'):
        'the TPU\'s gather rate; no counterpart on the card',
    ('compressjs_tpu.parallel.pipeline', 'DeviceBzip2Encoder.FETCH_BUCKET'):
        'bounds XLA compiles per shape, which the port does not have '
        '(ROADMAP C2)',
}
SIGNATURES = {
    ('compressjs_tpu.ops.huffman_stages', 'optimize_groups'):
        'the port takes ref_ties explicitly; its callers read '
        'COMPRESSJS_TPU_BZ2_REF_TIES (host.bzip2._finish_block)',
}

_PLAIN = (int, float, str, bool, type(None))


def _module(path):
    """A module by its dotted path, or an attribute that holds one (the
    port's ``BWT`` and ``utils.crc32``)."""
    try:
        return importlib.import_module(path)
    except ModuleNotFoundError:
        parent, _, name = path.rpartition('.')
        return getattr(_module(parent), name)


def _public(tree, imports):
    """{name: ast node or None} of a module's public top-level defs,
    classes and upper-case constants (and, with `imports`, the names it
    imports)."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id.isupper():
                    out[t.id] = None
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out[(a.asname or a.name).split('.')[0]] = None
    return {k: v for k, v in out.items() if not k.startswith('_')}


def _names(jax_path):
    """[(name, class member or None)] of the JAX module's public
    surface."""
    mod = importlib.import_module(jax_path)
    src = inspect.getsource(mod)
    is_pkg = mod.__file__.endswith('__init__.py')
    names = _public(ast.parse(src), is_pkg)
    if jax_path == 'compressjs_tpu':
        names.update({k: None for k in mod._CODEC_MODULES})
        names['version'] = None
    out = []
    for name, node in sorted(names.items()):
        out.append((name, None))
        if isinstance(node, ast.ClassDef):
            for m in _public(ast.Module(body=node.body, type_ignores=[]),
                             False):
                out.append((name, m))
    return out


def _cases(table):
    return [(j, name, member) for j in sorted(table)
            for name, member in _names(j)]


HOST_CASES = _cases(HOST)
DEVICE_CASES = _cases(DEVICE)


def _key(name, member):
    return name if member is None else '%s.%s' % (name, member)


def _lookup(mods, name, member):
    for mod in mods:
        if hasattr(mod, name):
            obj = getattr(mod, name)
            if member is None:
                return True, obj
            if hasattr(obj, member):
                return True, getattr(obj, member)
    return False, None


def _params(obj):
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [p for p in sig.parameters.values()
            if not p.name.startswith('_') and p.name != 'self']


def _check_params(want, got):
    """None, or what differs between JAX's parameters and the port's."""
    for i, p in enumerate(want):
        if i >= len(got):
            return 'no parameter %r' % p.name
        q = got[i]
        if (q.name, q.kind) != (p.name, p.kind):
            return 'parameter %d is %r, not %r' % (i, q.name, p.name)
        if p.default is not p.empty:
            if q.default is q.empty:
                return '%r has no default' % p.name
            if (isinstance(p.default, _PLAIN)
                    and q.default != p.default):
                return '%r defaults to %r, not %r' % (p.name, q.default,
                                                      p.default)
    for q in got[len(want):]:
        if q.default is q.empty and q.kind not in (q.VAR_POSITIONAL,
                                                   q.VAR_KEYWORD):
            return 'added parameter %r has no default' % q.name
    return None


@pytest.mark.parametrize('jax_path,name,member', HOST_CASES,
                         ids=['%s:%s' % (j, _key(n, m))
                              for j, n, m in HOST_CASES])
def test_host_name_has_counterpart(jax_path, name, member):
    key = (jax_path, _key(name, member))
    found, got = _lookup([_module(HOST[jax_path])], name, member)
    assert key not in EXCLUDED
    assert found, 'the port has no %s for %s' % (key[1], jax_path)
    want = getattr(importlib.import_module(jax_path), name)
    if member is not None:
        want = getattr(want, member)
    if not callable(want) or not callable(got) or key in SIGNATURES:
        return
    if inspect.isclass(want) and inspect.isclass(got):
        want, got = want.__init__, got.__init__
    p, q = _params(want), _params(got)
    if p is not None and q is not None:
        assert _check_params(p, q) is None, (key, _check_params(p, q))


@pytest.mark.parametrize('jax_path,name,member', DEVICE_CASES,
                         ids=['%s:%s' % (j, _key(n, m))
                              for j, n, m in DEVICE_CASES])
def test_device_name_has_counterpart(jax_path, name, member):
    key = (jax_path, _key(name, member))
    found, _ = _lookup([_module(p) for p in DEVICE[jax_path]], name, member)
    if key in EXCLUDED:
        assert not found, 'excluded, yet the port has it: %s' % (key,)
    else:
        assert found, 'the port has no %s for %s' % (key[1], jax_path)


def test_exclusions_are_live_and_reasoned():
    """Every exclusion names a JAX name the comparison meets, with a
    one-line reason; every signature exception a callable that differs."""
    seen = {(j, _key(n, m)) for j, n, m in HOST_CASES + DEVICE_CASES}
    for key, reason in list(EXCLUDED.items()) + list(SIGNATURES.items()):
        assert key in seen, key
        assert reason and '\n' not in reason
    for (jax_path, name) in SIGNATURES:
        want = _params(getattr(importlib.import_module(jax_path), name))
        got = _params(getattr(_module(HOST[jax_path]), name))
        assert _check_params(want, got) is not None
