"""Length-limited Huffman code-length allocation, scalar loops.

In-place algorithm of Milidiu, Pessoa and Laber ("In-Place
Length-Restricted Prefix Coding") with the shcodec-style refinements:
the input is a *sorted* frequency list which is mutated into code
lengths.  This is the plain version of the CUDA allocator kernel
(``ops.device_entropy.alloc_lengths``), which runs the same loops.
"""

from __future__ import annotations


def _first(array, i, nodes_to_move):
    """Smallest k with nodes_to_move <= k <= i and i <= array[k] % len."""
    length = len(array)
    limit = i
    k = length - 2
    while i >= nodes_to_move and (array[i] % length) > limit:
        k = i
        i -= (limit - i + 1)
    i = max(nodes_to_move - 1, i)
    while k > i + 1:
        mid = (i + k) >> 1
        if (array[mid] % length) > limit:
            k = mid
        else:
            i = mid
    return k


def _set_extended_parent_pointers(array):
    length = len(array)
    array[0] += array[1]
    head, top = 0, 2
    for tail in range(1, length - 1):
        if top >= length or array[head] < array[top]:
            total = array[head]
            array[head] = tail
            head += 1
        else:
            total = array[top]
            top += 1
        if top >= length or (head < tail and array[head] < array[top]):
            total += array[head]
            array[head] = tail + length
            head += 1
        else:
            total += array[top]
            top += 1
        array[tail] = total


def _find_nodes_to_relocate(array, maximum_length):
    node = len(array) - 2
    depth = 1
    while depth < maximum_length - 1 and node > 1:
        node = _first(array, node - 1, 0)
        depth += 1
    return node


def _allocate_node_lengths(array):
    first_node = len(array) - 2
    next_node = len(array) - 1
    depth, available = 1, 2
    while available > 0:
        last_node = first_node
        first_node = _first(array, last_node - 1, 0)
        for _ in range(available - (last_node - first_node)):
            array[next_node] = depth
            next_node -= 1
        available = (last_node - first_node) << 1
        depth += 1


def _allocate_node_lengths_with_relocation(array, nodes_to_move,
                                           insert_depth):
    first_node = len(array) - 2
    next_node = len(array) - 1
    depth = 2 if insert_depth == 1 else 1
    left_to_move = nodes_to_move - 2 if insert_depth == 1 else nodes_to_move
    available = depth << 1
    while available > 0:
        last_node = first_node
        if first_node > nodes_to_move:
            first_node = _first(array, last_node - 1, nodes_to_move)
        offset = 0
        if depth >= insert_depth:
            offset = min(left_to_move, 1 << (depth - insert_depth))
        elif depth == insert_depth - 1:
            offset = 1
            if array[first_node] == last_node:
                first_node += 1
        for _ in range(available - (last_node - first_node + offset)):
            array[next_node] = depth
            next_node -= 1
        left_to_move -= offset
        available = (last_node - first_node + offset) << 1
        depth += 1


def allocate_huffman_code_lengths(array, maximum_length):
    """Mutate `array` (sorted symbol frequencies, a list) into canonical
    Huffman code lengths, none exceeding maximum_length."""
    n = len(array)
    if n <= 2:
        if n == 2:
            array[1] = 1
        if n >= 1:
            array[0] = 1
        return
    _set_extended_parent_pointers(array)
    nodes_to_relocate = _find_nodes_to_relocate(array, maximum_length)
    if (array[0] % n) >= nodes_to_relocate:
        _allocate_node_lengths(array)
    else:
        insert_depth = maximum_length - (nodes_to_relocate - 1).bit_length()
        _allocate_node_lengths_with_relocation(array, nodes_to_relocate,
                                               insert_depth)
