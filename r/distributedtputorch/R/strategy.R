# Distribution strategies + cluster config from R.
#
# Set the cluster spec via an env var, join the gang (initialize_cluster:
# one process per GPU, a torch.distributed group), then build the strategy
# and the model inside its scope; the same script runs on every worker,
# differing only in the index. `device = NULL` is the GPU (this worker's
# card in a gang); `device = "cpu"` runs on the CPU (a gloo group).

#' @export
single_device_strategy <- function(device = NULL) {
  dtpu()$SingleDevice(device = device)
}

#' Synchronous data-parallel strategy over the process group (one process
#' per GPU). Without a group it forms one of this process alone.
#' @export
data_parallel_strategy <- function(device = NULL) {
  dtpu()$DataParallel(device = device)
}

#' Alias keeping the reference's class name greppable for migrating users
#' (README.md:122: tf$distribute$experimental$MultiWorkerMirroredStrategy()).
#' @export
multi_worker_mirrored_strategy <- function(device = NULL) {
  dtpu()$MultiWorkerMirroredStrategy(device = device)
}

#' @export
num_replicas_in_sync <- function(strategy) strategy$num_replicas_in_sync

#' Build a model (or run any expression) inside the strategy's scope —
#' the scope-wraps-construction contract of the reference
#' (`with(strategy$scope(), {...})`, README.md:134-151).
#' @export
with_strategy_scope <- function(strategy, expr) {
  ctx <- strategy$scope()
  ctx$`__enter__`()
  on.exit(ctx$`__exit__`(NULL, NULL, NULL), add = TRUE)
  force(expr)
}

#' Set the cluster spec env var for this worker, replacing the reference's
#' hand-built TF_CONFIG JSON (README.md:84-89). Must run before the first
#' strategy/model construction (same before-init ordering the reference
#' demands, README.md:80).
#' @param workers character vector of "host:port" for every worker
#' @param index this worker's 0-based rank
#' @export
set_cluster_spec <- function(workers, index) {
  spec <- jsonlite::toJSON(
    list(
      cluster = list(worker = as.list(workers)),
      task = list(type = "worker", index = as.integer(index))
    ),
    auto_unbox = TRUE
  )
  Sys.setenv(DTPU_CONFIG = as.character(spec))
  invisible(spec)
}

#' Join the gang the cluster spec describes (set_cluster_spec or
#' barrier_cluster_spec): each worker forms the torch.distributed group with
#' its peers, before the first strategy is built. Blocks until every worker
#' has joined.
#' @export
initialize_cluster <- function(device = NULL) {
  invisible(dtpu()$cluster$initialize(device = device))
}

#' Cluster spec from a Spark barrier context (the reference's spark_apply
#' closure, README.md:180-183): peers from barrier$address with Spark's
#' ports stripped and re-assigned, rank from barrier$partition.
#' @export
barrier_cluster_spec <- function(addresses, partition, base_port = 8000L) {
  hosts <- gsub(":[0-9]+$", "", addresses)
  workers <- paste0(hosts, ":", base_port + seq_along(hosts))
  set_cluster_spec(workers, as.integer(partition))
}
