"""Predefined reference-path loops on the CPM lab map.

Data transcription of the reference's hand-designed lanelet loop tables
(scenarios/road_network/get_reference_lanelets_loop.m): 12 loops of lanelet
ids; each of the 41+ path ids selects a loop and a starting lanelet, and the
loop is rotated to start there. This is map data (which lanelets form each
driving loop), required for `path_ids` parity with the reference.
"""

from __future__ import annotations

# Loop id (1-based) -> lanelet id sequence
# (get_reference_lanelets_loop.m:24-37)
REFERENCE_LANELET_LOOPS: dict[int, list[int]] = {
    1: [4, 6, 8, 60, 58, 56, 54, 80, 82, 84, 86, 34, 32, 30, 28, 2],
    2: [1, 3, 23, 10, 12, 17, 43, 38, 36, 49, 29, 27],
    3: [64, 62, 75, 55, 53, 79, 81, 101, 88, 90, 95, 69],
    4: [40, 45, 97, 92, 94, 100, 83, 85, 33, 31, 48, 42],
    5: [5, 7, 59, 57, 74, 68, 66, 71, 19, 14, 16, 22],
    6: [41, 39, 20, 63, 61, 57, 55, 67, 65, 98, 37, 35, 31, 29],
    7: [3, 5, 9, 11, 72, 91, 93, 81, 83, 87, 89, 46, 13, 15],
    # 8: right turns at the intersection (overlapping path, intersection use)
    8: [1, 3, 23, 10, 12, 18, 14, 16, 22, 5, 7, 59, 57, 74, 68, 66, 70,
        64, 62, 75, 55, 53, 79, 81, 101, 88, 90, 96, 92, 94, 100, 83, 85,
        33, 31, 48, 42, 40, 44, 38, 36, 49, 29, 27],
    # 9-12: straight through the intersection from the left lane (N/E/S/W)
    9: [1, 3, 5, 9, 11, 26, 52, 37, 35, 31, 29, 27],
    10: [3, 5, 7, 59, 57, 55, 67, 65, 76, 24, 13, 15],
    11: [79, 81, 83, 87, 89, 104, 78, 63, 61, 57, 55, 53],
    12: [33, 31, 29, 41, 39, 50, 102, 91, 93, 81, 83, 85],
}

# path_id -> (loop id, starting lanelet)
# (get_reference_lanelets_loop.m:39-141)
PATH_ID_TABLE: dict[int, tuple[int, int]] = {
    1: (1, 4), 2: (1, 8), 3: (1, 58), 4: (1, 54), 5: (1, 82), 6: (1, 86),
    7: (1, 32), 8: (1, 28),
    9: (2, 1), 10: (2, 10), 11: (2, 17), 12: (2, 38), 13: (2, 49),
    14: (3, 64), 15: (3, 75), 16: (3, 79), 17: (3, 88), 18: (3, 95),
    19: (4, 42), 20: (4, 45), 21: (4, 92), 22: (4, 100), 23: (4, 33),
    24: (5, 22), 25: (5, 59), 26: (5, 68), 27: (5, 19), 28: (5, 14),
    29: (6, 39), 30: (6, 61), 31: (6, 55), 32: (6, 65), 33: (6, 35),
    34: (6, 29),
    35: (7, 15), 36: (7, 5), 37: (7, 11), 38: (7, 93), 39: (7, 83),
    40: (7, 89),
    41: (5, 71),
    51: (8, 18), 52: (8, 70), 53: (8, 96), 54: (8, 44),
    61: (9, 26), 62: (10, 76), 63: (11, 104), 64: (12, 50),
}


def get_reference_lanelets_loop(path_id: int) -> list[int]:
    """Lanelet id sequence for a path id, rotated to its starting lanelet."""
    loop_id, start = PATH_ID_TABLE[path_id]
    loop = REFERENCE_LANELET_LOOPS[loop_id]
    i = loop.index(start)
    return loop[i:] + loop[:i]
