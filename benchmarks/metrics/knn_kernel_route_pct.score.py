"""knn_kernel_route_pct.score: the share of the traced window's KNN mask
shards that a kernel scored, in percent: 100 (K6 + K7 launches) over (K6 +
K7 launches + the generic route's mask shards, ``knn_generic``), from the
program's ``knn_score.launch_counts()``. None where none of them ran."""


def read(r):
    launches = r["launches"]
    kernel = launches.get("knn_scores_resident", 0) + launches.get("knn_scores_stream", 0)
    total = kernel + launches.get("knn_generic", 0)
    if not total:
        return None
    return 100.0 * kernel / total
