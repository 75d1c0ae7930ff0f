#!/usr/bin/env bash
# Bring up the port's web platform on a GPU host (the counterpart of
# deploy/deploy.sh). The image (Dockerfile beside this script) is built from
# the repository root with the CUDA kernels and the native decoder in it;
# the data-processing and model-prediction workers reserve the GPU, which
# needs the NVIDIA Container Toolkit on the host.
#   ./deploy.sh up            — build + start the dev stack
#   ./deploy.sh prod          — build + start the prod stack
#   ./deploy.sh prod-tunnel   — prod stack + cloudflared ingress
#   ./deploy.sh down          — stop (either stack)
#   ./deploy.sh logs          — follow logs
set -euo pipefail
cd "$(dirname "$0")"
case "${1:-up}" in
  up)   docker compose up --build -d ;;
  prod) docker compose -f docker-compose.prod.yml up --build -d ;;
  prod-tunnel)
        docker compose -f docker-compose.prod.yml --profile cloudflare \
          up --build -d ;;
  down) docker compose down
        docker compose -f docker-compose.prod.yml down 2>/dev/null || true ;;
  logs) docker compose logs -f 2>/dev/null \
          || docker compose -f docker-compose.prod.yml logs -f ;;
  *) echo "usage: $0 {up|prod|prod-tunnel|down|logs}" >&2; exit 1 ;;
esac
