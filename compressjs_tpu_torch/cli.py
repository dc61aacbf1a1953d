"""Command line of the port, the contract of ``compressjs_tpu.cli``:
-z/-d, -t <codec> (17 dispatch names), -1..-9 (default level 7), -b
<bitpos> to extract one bzip2 block, file arguments or stdin/stdout.

Usage:  python -m compressjs_tpu_torch.cli -z -t bzip2 -9 [infile] [outfile]
        python -m compressjs_tpu_torch.cli -d -t bzip2 [infile] [outfile]
        python -m compressjs_tpu_torch.cli -d -t bzip2 -b 544888 in.bz2 out

One option more than the JAX package's: ``--device {cuda,cpu}`` (default
cuda).  The encodes that have a card path take it on that device and
give the host codec's bytes: ``bzip``/``bzip2`` (`compress_file_device`,
MTF and the Huffman tables on the card), ``bwtc`` (`DeviceBWTCEncoder`)
and ``bwtcp`` (`bwtcp_compress_device`, MTF and the Fenwick model and
coder on the card).  Without a card they exit 1 and write nothing; they
never go on on the CPU unless asked to.  Every decode, block extraction
and other encode runs the host codec (``host``), as the JAX command line
runs its own; the bzip2 decode is the parallel native host decode.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# the encodes that run on --device
CARD_ROUTES = ('bzip', 'bzip2', 'bwtc', 'bwtcp')


def _dispatch(name):
    import compressjs_tpu_torch as cz
    table = {
        # models and coders (self-test codecs)
        'defsum': cz.DefSumModel,
        'fenwick': cz.FenwickModel,
        'mtf': cz.MTFModel,
        'context1': cz.Context1Model,
        'no': cz.NoModel,
        'huff': cz.Huffman,
        'huffman': cz.Huffman,
        # compression methods
        'bwtc': cz.BWTC,
        'bwtcp': cz.BWTCP,
        'bzip': cz.Bzip2,
        'bzip2': cz.Bzip2,
        'dmc': cz.Dmc,
        'lzjb': cz.Lzjb,
        'lzjbr': cz.LzjbR,
        'lzp3': cz.Lzp3,
        'ppm': cz.PPM,
        'simple': cz.Simple,
    }
    key = name.lower()
    if key not in table:
        print('Unknown compressor: %s' % name, file=sys.stderr)
        raise SystemExit(1)
    return table[key]


class CardEncoder:
    """The ``compress_file`` of a card route: the encode on `device`,
    its bytes returned (uint8 array) or written to the output stream."""

    def __init__(self, key, device):
        self.key = key
        self.device = device

    def compress_file(self, data, output=None, level=9):
        import compressjs_tpu_torch as cz
        if self.key in ('bzip', 'bzip2'):
            out = cz.compress_file_device(data, level=level,
                                          device=self.device)
        elif self.key == 'bwtc':
            out = cz.DeviceBWTCEncoder(level, device=self.device) \
                .compress(data)
        else:
            out = cz.bwtcp_compress_device(data, level=level,
                                           device=self.device)
        out = np.frombuffer(out, dtype=np.uint8) \
            if isinstance(out, (bytes, bytearray)) \
            else np.asarray(out, dtype=np.uint8)
        if output is None:
            return out
        output.write_array(out)
        return output


def _version():
    import compressjs_tpu_torch
    return compressjs_tpu_torch.version


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='compressjs_tpu_torch',
        usage='%(prog)s -d|-z [--device cuda|cpu] [infile] [outfile]')
    p.add_argument('-V', '--version', action='version',
                   version='%(prog)s ' + _version())
    p.add_argument('-d', '--decompress', action='store_true',
                   help='Decompress infile to outfile')
    p.add_argument('-z', '--compress', action='store_true',
                   help='Compress infile to outfile')
    p.add_argument('-b', '--block', type=int, default=-1,
                   help='Extract a single block, starting at <n> bits.')
    p.add_argument('-t', dest='codec', default=None,
                   help='Select compressor type')
    p.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                   help='Where the bzip2, bwtc and bwtcp encodes run '
                        '(default cuda)')
    for lvl in range(1, 10):
        p.add_argument('-%d' % lvl, dest='level%d' % lvl,
                       action='store_true',
                       help=('Fastest/largest compression' if lvl == 1 else
                             'Slowest/smallest compression' if lvl == 9 else
                             argparse.SUPPRESS))
    p.add_argument('infile', nargs='?')
    p.add_argument('outfile', nargs='?')
    args = p.parse_args(argv)

    if not args.decompress:
        args.compress = True
    if args.decompress and args.compress:
        print('Must specify either -d or -z.', file=sys.stderr)
        return 1
    if args.compress and args.block >= 0:
        print('--block can only be used with decompression', file=sys.stderr)
        return 1

    level = None
    for lvl in range(1, 10):
        if getattr(args, 'level%d' % lvl):
            if level:
                print("Can't specify both -%d and -%d" % (level, lvl),
                      file=sys.stderr)
                return 1
            level = lvl
    if level and args.decompress:
        print('Compression level has no effect when decompressing.',
              file=sys.stderr)
        return 1
    if not level:
        level = 7  # default

    name = args.codec or 'lzp3'
    codec = _dispatch(name)
    if args.compress and name.lower() in CARD_ROUTES:
        if args.device == 'cuda':
            import torch
            if not torch.cuda.is_available():
                print('error: no CUDA device was found for the %s encode '
                      '(--device cuda); pass --device cpu to run it on the '
                      'CPU' % name.lower(), file=sys.stderr)
                return 1
        codec = CardEncoder(name.lower(), args.device)

    try:
        if args.infile:
            if os.path.getsize(args.infile) > (64 << 20):
                # large inputs: memory-map so block codecs stream from disk
                data = np.memmap(args.infile, dtype=np.uint8, mode='r')
            else:
                with open(args.infile, 'rb') as f:
                    data = f.read()
        else:
            data = sys.stdin.buffer.read()
    except OSError as e:
        print('error: %s' % e, file=sys.stderr)
        return 1

    # with an output file, the codec writes straight to disk through a
    # temp file renamed into place on success, so a failure never
    # truncates or deletes a file at the destination (and `in == out`
    # cannot destroy its own input); block extraction returns an array
    from .host.stream import FileOutputStream
    sink = None
    tmp_path = None
    out = None
    try:
        if args.outfile and args.block < 0:
            tmp_path = '%s.tmp.%d' % (args.outfile, os.getpid())
            sink_file = open(tmp_path, 'wb')
            sink = FileOutputStream(sink_file)
        if args.decompress:
            if args.block >= 0:
                if not hasattr(codec, 'decompress_block'):
                    print('--block requires a random-access codec (bzip2)',
                          file=sys.stderr)
                    return 1
                out = codec.decompress_block(data, args.block)
            else:
                out = codec.decompress_file(data, sink) if sink is not None \
                    else codec.decompress_file(data)
        else:
            out = codec.compress_file(data, sink, level)
        if sink is not None:
            sink.flush()
            sink_file.close()
            os.replace(tmp_path, args.outfile)
            return 0
    except Exception as e:  # corrupt input, IO, no card: a clean message
        if sink is not None:   # drop the temp; the destination untouched
            try:
                sink_file.close()
                os.unlink(tmp_path)
            except OSError:
                pass
        print('error: %s' % e, file=sys.stderr)
        return 1

    out_bytes = bytes(np.asarray(out, dtype=np.uint8))
    try:
        if args.outfile:
            with open(args.outfile, 'wb') as f:
                f.write(out_bytes)
        else:
            sys.stdout.buffer.write(out_bytes)
    except OSError as e:
        print('error: %s' % e, file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
