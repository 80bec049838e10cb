import sys

from tpu_pod_exporter_torch.app import main

if __name__ == "__main__":
    sys.exit(main())
