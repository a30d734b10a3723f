"""The port's local web GUI: a standard-library HTTP server and one static
page that configure a search, launch ``alphadia-torch`` as a process of
its own and show its log, history, results and figures."""
